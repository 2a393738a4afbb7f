"""``BENCHMARK.json`` and the files it names, found by name.

``configs/<config>.json``, ``traffic/<mix>.json`` and
``metrics/<metric>.py`` under this directory; a configuration names its
corpus generator (``corpora/<generator>.py``), its system
(``systems/<system>.py``) and its reference (``references/<name>.py``).
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(path=None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   + ", ".join(w["name"] for w in bench["workloads"]))


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def module(kind: str, name: str):
    """``bench.<kind>.<name>``: a corpus generator, system, reference or
    per-layer metric reader."""
    if not NAME.match(name) or "." in name:
        raise ValueError(f"bad {kind} name {name!r}")
    return importlib.import_module(f"bench.{kind}.{name}")


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics this cell reports: those that list it, or
    list no cells and move an end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (cell_name in cells) if cells is not None else m["moves"] in e2e:
            out.append(m)
    return out


def end_to_end(bench: dict, cell_name: str) -> list:
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]
