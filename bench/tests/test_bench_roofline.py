"""The frozen roofline counts, the trace reading and the per-layer
readers on a record made by hand."""

import pytest

from bench import manifest, roofline, tracing


def test_counts_match_the_kernel_phase():
    # chip_smoke.py's K2 row: 1M x (10 + 48), Q = 8, alphabets 16 / 32
    n_bytes, n_ops = roofline.k2_work(1, 8, 1_000_000, 10, 48, 16, 32)
    assert n_bytes == 1_000_000 * 58 * 4 + 8 * 1_000_000 * 4 \
        + 8 * 2 * (10 * 16 + 48 * 32) * 4
    assert n_ops == 6 * 8 * 1_000_000 * 480
    assert roofline.bound_s(n_bytes, n_ops) * 1e3 == pytest.approx(
        0.34388, abs=1e-5)
    # K1: every pair reads its row, its index, writes its distance
    assert roofline.k1_work(10, 960) == (10 * (3840 + 12), 3 * 10 * 960)
    assert roofline.share_pct((3.35e12, 0), 2.0) == pytest.approx(50.0)
    assert roofline.share_pct((1, 1), 0.0) is None


def _event(cat, name, ts, dur):
    return cat, name, ts, dur


def test_trace_parse_busy_kernels_and_gaps():
    ev = [_event("kernel", "void (anonymous namespace)::euclid_kernel<float,"
                 " true>(float const*)", 0, 10),
          _event("kernel", "void ssax_dist_batch_kernel(Params)", 5, 10),
          _event("gpu_memcpy", "Memcpy HtoD", 100, 20),
          _event("cpu_op", "aten::to", 10, 200),
          _event("cuda_runtime", "cudaStreamSynchronize", 30, 60),
          _event("cpu_instant_event", "x", 0, 0)]
    t = tracing.parse(ev)
    assert t["busy_s"] == pytest.approx(35e-6)
    assert t["kernels"]["(anonymous namespace)::euclid_kernel<float, true>"
                        ]["n"] == 1
    assert t["kernels"]["gpu_memcpy"]["s"] == pytest.approx(20e-6)
    assert t["idle_gaps"] == {"cudaStreamSynchronize": pytest.approx(85e-6)}
    b = tracing.breakdown(t)
    assert b["device_ops"][0][1] == pytest.approx(20e-6)
    assert len(b["idle_gaps"]) == 1


class _Event:
    def __init__(self, device, name):
        self._d, self._n = device, name

    def device_type(self):
        return self._d

    def name(self):
        return self._n


def test_event_categories():
    assert tracing.category(_Event("DeviceType.CUDA", "void k<1>()")) == \
        "kernel"
    assert tracing.category(_Event("DeviceType.CUDA", "Memcpy HtoD "
                                   "(Pageable -> Device)")) == "gpu_memcpy"
    assert tracing.category(_Event("DeviceType.CUDA", "Memset (Device)")) \
        == "gpu_memset"
    assert tracing.category(_Event("DeviceType.CPU", "cudaLaunchKernel")) \
        == "host"


def _record(cfg_name):
    b = manifest.load()
    cfg = manifest.config(b, cfg_name)
    n = cfg["corpus"]["n"]
    kernels = {"(anonymous namespace)::euclid_kernel<float, true>":
               {"s": 0.5, "n": 100},
               "(anonymous namespace)::ssax_dist_batch_kernel<4>":
               {"s": 2.0, "n": 10},
               "at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<x>":
               {"s": 1.0, "n": 40},
               "at::native::vectorized_elementwise_kernel<4>":
               {"s": 0.1, "n": 9}}
    return {"counters": {"serve.batches": 10.0,
                         "serve.batched_requests": 600.0,
                         "match.queries": 640.0,
                         "match.candidates_verified": 640.0 * 500},
            "engine_calls": 10,
            "trace": {"kernels": kernels, "busy_s": 4.0, "idle_gaps": {}},
            "window_s": 10.0, "config": cfg, "n_rows": n,
            "latency_s": [0.5] * 19 + [1.5]}


def test_readers_on_a_record():
    rec = _record("ssax-season50g")
    read = {m: manifest.module("metrics", m).read(rec) for m in (
        "requests_per_dispatch", "rows_verified_per_query",
        "order_device_ms_per_dispatch", "k1_roofline_pct",
        "k2_roofline_pct", "device_idle_pct")}
    assert read["requests_per_dispatch"] == 60.0
    assert read["rows_verified_per_query"] == 500.0
    assert read["order_device_ms_per_dispatch"] == pytest.approx(100.0)
    assert read["device_idle_pct"] == pytest.approx(60.0)
    assert manifest.module("metrics", "latency_p95_ms").read(rec) == \
        pytest.approx(550.0)
    n = rec["n_rows"]
    k2 = roofline.k2_work(10, 640, n, 10, 48, 9, 64)
    assert read["k2_roofline_pct"] == pytest.approx(
        100 * roofline.bound_s(*k2) / 2.0)
    k1 = roofline.k1_work(640 * 500, 960)
    assert read["k1_roofline_pct"] == pytest.approx(
        100 * roofline.bound_s(*k1) / 0.5)


def test_sweep_bound_follows_the_work_not_the_launches():
    """The same sweeps in one launch per engine call, one per query or
    two per query read the same bound; more queries read more."""
    k2 = manifest.module("metrics", "k2_roofline_pct")
    reads = []
    for launches in (10, 640, 1280):
        rec = _record("ssax-season50g")
        rec["trace"]["kernels"][
            "(anonymous namespace)::ssax_dist_batch_kernel<4>"] = {
                "s": 2.0, "n": launches}
        reads.append(k2.read(rec))
    assert reads[0] == reads[1] == reads[2]
    rec = _record("ssax-season50g")
    rec["counters"]["match.queries"] *= 2
    assert k2.read(rec) > reads[0]


def test_readers_return_nothing_without_their_work():
    rec = _record("ssax-season50g")
    rec["trace"] = {"kernels": {}, "busy_s": 0.0, "idle_gaps": {}}
    rec["counters"] = {}
    rec["latency_s"] = []
    for m in manifest.load()["per_layer"]:
        assert manifest.module("metrics", m["name"]).read(rec) is None, m
