"""The readers of the program's spans (``repro_torch.obs.trace``) on
records made by hand, and a CPU traced run whose registry holds the
spans' counters."""

import pytest

from bench import cell, manifest

CELL = "ssax-season50g-c64-k1"
K1 = "(anonymous namespace)::euclid_kernel<float, true>"
SPAN_METRICS = ("k1_rounds_per_dispatch", "round_host_us", "engine_host_pct",
                "submit_us", "queue_wait_ms")
COUNTERS = {"serve.batches": 10.0, "serve.batched_requests": 500.0,
            "serve.submit_s": 0.005, "serve.submit_calls": 100.0,
            "serve.queue_wait_s": 40.0,
            "serve.coalesce_s": 0.25, "serve.dispatch_s": 49.0,
            "match.topk_s": 4.0,
            "match.sweep.wait_s": 1.0, "match.round.wait_s": 0.5,
            "match.round_s": 2.5, "match.rounds": 400.0}
WANT = {"k1_rounds_per_dispatch": 40.0,
        "round_host_us": 1e6 * 2.0 / 400,
        "engine_host_pct": 100.0 * 2.5 / 50.0,
        "submit_us": 50.0,
        "queue_wait_ms": 80.0}


def _rec(counters=None, busy_s=10.0, k1=True):
    kernels = {K1: {"s": 0.1, "n": 400}} if k1 else {}
    return {"counters": dict(COUNTERS if counters is None else counters),
            "trace": {"busy_s": busy_s, "kernels": kernels},
            "window_s": 50.0}


def _read(name, rec):
    return manifest.module("metrics", name).read(rec)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_value_and_nothing_to_read(name):
    assert _read(name, _rec()) == pytest.approx(WANT[name])
    # no device work in the window: the CPU's traced run
    assert _read(name, _rec(busy_s=0.0)) is None
    # a program without the spans: the counters are absent
    spans = {k: v for k, v in COUNTERS.items()
             if k in ("serve.batches", "serve.batched_requests")}
    assert _read(name, _rec(spans)) is None


@pytest.mark.parametrize("name", ["k1_rounds_per_dispatch", "round_host_us"])
def test_round_readers_need_a_k1_launch(name):
    assert _read(name, _rec(k1=False)) is None


@pytest.mark.parametrize("name,zero", [
    ("k1_rounds_per_dispatch", "serve.batches"),
    ("round_host_us", "match.rounds"),
    ("submit_us", "serve.submit_calls"),
    ("queue_wait_ms", "serve.batched_requests")])
def test_zero_denominator_reads_none(name, zero):
    assert _read(name, _rec({**COUNTERS, zero: 0.0})) is None


def test_manifest_lists_the_span_metrics_for_the_cell():
    bench = manifest.load()
    listed = {m["name"]: m for m in manifest.per_layer(bench, CELL)}
    for name in SPAN_METRICS:
        m = listed[name]
        assert m["moves"] == "qps" and m["source"] == "program_counter"
        assert m["layer"].split(" ")[0] in ("engine", "service")


def test_cpu_traced_run_records_the_span_counters():
    regs = []
    sizes = {"corpus": {"n": 2000, "chunk": 1024}, "pool": 128,
             "clients": 8, "session": {"window_s": 0.002, "max_batch": 8}}
    r = cell.run(CELL, 2 ** 31 + 11, 0.4, True, device="cpu", sizes=sizes,
                 wrap=lambda system: regs.append(system.metrics))
    assert r["correct"]
    # the card's readers find no device work here, as the others do
    assert not set(SPAN_METRICS) & set(r["metrics"])
    c = regs[0].snapshot()["counters"]
    for name in ("serve.submit_s", "serve.submit_calls",
                 "serve.queue_wait_s", "serve.coalesce_s",
                 "serve.dispatch_s", "match.topk_s", "match.sweep_s",
                 "match.round_s", "match.rounds"):
        assert c.get(name, 0) > 0, name
    assert c["serve.submit_calls"] == c["serve.requests"]
    assert c["serve.dispatch_s"] >= c["match.topk_s"] >= c["match.sweep_s"]
