"""A whole run of a cell on the CPU at a small size: the result line's
keys, the command's refusal without a card, and the timed path broken
underneath, which the check has to catch."""

import json
import subprocess
import sys

import pytest

from bench import cell, manifest

SIZES = {"corpus": {"n": 2000, "chunk": 1024}, "pool": 128, "clients": 8,
         "session": {"window_s": 0.002, "max_batch": 8}}
CELLS = [w["name"] for w in manifest.load()["workloads"]]


def _run(workload, trace=False, wrap=None, seed=2 ** 31 + 5):
    return cell.run(workload, seed, 0.4, trace, device="cpu", sizes=SIZES,
                    wrap=wrap)


@pytest.mark.parametrize("workload", CELLS)
def test_result_line_keys(workload):
    r = _run(workload)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"] and list(r)[-1] == "checks"
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {
        m["name"] for m in manifest.end_to_end(manifest.load(), workload)}
    assert {"qps", "peak_device_gb", "setup_s"} <= set(r["metrics"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])
    assert r["checks"]["nn_err"]["value"] <= r["checks"]["nn_err"]["limit"]
    json.dumps(r, allow_nan=False)


def test_traced_line_keys():
    r = _run(CELLS[0], trace=True)
    assert r["correct"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU only the program's counters have something to read
    assert set(r["metrics"]) == {"requests_per_dispatch", "latency_p95_ms",
                                 "rows_verified_per_query"}


def test_command_without_a_card_prints_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=120, cwd=manifest.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_alone_without_the_port_prints_no_result(tmp_path):
    import shutil
    shutil.copytree(manifest.HERE, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=120, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_k_neighbours_mix():
    """A mix with k > 1, as later cells add it: every rank is checked."""
    r = cell.run(CELLS[0], 2 ** 31 + 7, 0.4, False, device="cpu",
                 sizes=dict(SIZES, k=8))
    assert r["correct"] and r["failed"] == 0
