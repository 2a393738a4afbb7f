"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from bench import manifest

B = manifest.load()
ROOT = manifest.ROOT
CELLS = [w["name"] for w in B["workloads"]]
E2E = {m["name"] for m in B["end_to_end"]}
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["bench"]
    assert B["command"] == ["python3", "bench/run.py"]
    assert 1 <= B["run_seconds"] <= 51 and isinstance(B["run_seconds"], int)
    assert len(json.dumps(B)) < 64 * 1024


def test_names_units_and_lines():
    names = ([c["name"] for c in B["configs"]] + CELLS
             + [m["name"] for m in B["end_to_end"] + B["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in B["workloads"]]:
        assert manifest.NAME.match(n), n
    for m in B["end_to_end"] + B["per_layer"]:
        assert manifest.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in B["configs"] + B["workloads"]]
                 + [c["source"] for c in B["configs"]]
                 + [m["layer"] for m in B["per_layer"]] + B["command"]):
        assert LINE.match(text), text


def test_every_file_found_by_name():
    for c in B["configs"]:
        assert c["file"].startswith("bench/configs/")
        cfg = manifest.config(B, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        for kind, key in (("corpora", cfg["corpus"]["generator"]),
                          ("systems", cfg["system"]),
                          ("references", cfg["reference"])):
            manifest.module(kind, key)
    for w in B["workloads"]:
        assert manifest.traffic(w["traffic"])["name"] == w["traffic"]
        manifest.config(B, w["config"])
    for m in B["per_layer"]:
        assert callable(manifest.module("metrics", m["name"]).read)


def test_metrics_moves_workloads_and_bounds():
    assert {"qps", "peak_device_gb", "setup_s"} == E2E
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in B["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in E2E and m["moves"] == "qps"
        assert set(m["workloads"]) <= set(CELLS)
    layers = {}
    for m in B["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    w = manifest.cell(B, cell)
    assert w["chips"] == 1 and LINE.match(w["why"])
    e2e = {m["name"] for m in manifest.end_to_end(B, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.per_layer(B, cell)
    assert (w["config"], w["traffic"]) not in {
        (v["config"], v["traffic"]) for v in B["workloads"]
        if v["name"] != cell}


def test_paths_hold_only_the_benchmark():
    files = [p.relative_to(ROOT) for p in (ROOT / "bench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts]
    for f in files:
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(f)), f
        assert f.suffix in (".py", ".json"), f
