"""The port's dry-run (``launch/dryrun.py``, ``launch/hillclimb.py``) on
the CPU, as ``tests/test_distributed.py``'s and ``test_launchers.py``'s
dry-run tests: a cell on a (4, 2) mesh description has FLOPs and
collectives, the optimized-serve cells come back ``ok``, and the CLI
prints ``1 ok``.  Beside them: the per-device bytes are each leaf's
shard, and the traced extrapolation (no and one repeat, one microbatch)
equals a trace at full depth with every microbatch.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import hillclimb  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.sharding import ShardingRules  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DEBUG = MeshSpec(("data", "model"), (4, 2))


@pytest.fixture
def debug_mesh(monkeypatch):
    """The production mesh swapped for a (4, 2) description."""
    monkeypatch.setattr(dr, "make_production_mesh",
                        lambda *, multi_pod=False: DEBUG)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_cell_on_debug_mesh(debug_mesh):
    rec = dr.dryrun_cell("smollm-135m", "train_4k", multi_pod=False)
    assert rec["status"] == "ok", rec
    assert rec["n_chips"] == 8 and rec["microbatch"] == 4
    assert rec["flops_per_dev"] > 0
    c = rec["collectives"]
    assert c["count"] > 0 and c["all-gather"] > 0 and \
        c["reduce-scatter"] > 0
    # the params' gathers: a leaf sharded over data and model is gathered
    # on model (a quarter of it out) then on data (all of it out)
    assert c["all-gather"] > 4 * rec["params_total"]


def test_dryrun_optimized_serve_on_debug_mesh(debug_mesh):
    kw = dict(dr.OPTIMIZED_SERVE)
    kw["rules_overrides"] = dict(kw["rules_overrides"], moe_groups=4)
    for arch in ("olmoe-1b-7b", "gemma3-12b"):
        rec = dr.dryrun_cell(arch, "decode_32k", multi_pod=False,
                             variant="serve_optimized", **kw)
        assert rec["status"] == "ok", rec
        assert rec["serve_dtype"] == "bfloat16"
        assert rec["flops_per_dev"] > 0


def test_dryrun_skips_full_attention_at_500k():
    rec = dr.dryrun_cell("qwen3-0.6b", "long_500k", multi_pod=False)
    assert rec["status"] == "skip(full-attn)"


def test_dryrun_launcher_single_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k", "--multi-pod", "single",
         "--out", str(tmp_path / "d.json")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == \
        "dry-run complete: 1 ok, 0 documented skips, 0 errors"


def test_importing_the_dryrun_sets_no_environment():
    code = ("import os\nbefore = dict(os.environ)\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.hillclimb\n"
            "assert dict(os.environ) == before\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_state_bytes_are_the_shards():
    cfg = get_config("qwen3-0.6b")
    n = cfg.param_counts()[0]
    one = ShardingRules.for_mesh(MeshSpec(("data", "model"), (1, 1)))
    assert dr.state_bytes(cfg, one) == {"params": 4 * n, "opt": 8 * n,
                                        "step": 4}
    # on 16 x 16 every leaf is split as its pspec says: no leaf of
    # qwen3-0.6b is replicated over both axes but the norms
    big = ShardingRules.for_mesh(MeshSpec(("data", "model"), (16, 16)))
    got = dr.state_bytes(cfg, big)
    assert 4 * n / 256 < got["params"] < 4 * n / 16
    low = dr.state_bytes(cfg, one, opt_dtype=torch.bfloat16,
                         param_dtype=torch.bfloat16)
    assert low == {"params": 2 * n, "opt": 4 * n, "step": 4}


@pytest.mark.parametrize("arch,mode", [("qwen3-0.6b", "train"),
                                       ("jamba-1.5-large-398b", "train"),
                                       ("whisper-medium", "prefill"),
                                       ("olmoe-1b-7b", "decode")])
def test_extrapolated_trace_equals_full_depth(arch, mode):
    """The dry-run's accounting (no and one repeat, one microbatch,
    extrapolated) equals one trace of the step at full depth with its
    microbatches, for a config of two repeats (two encoder layers)."""
    base = reduced(get_config(arch))
    cfg = dataclasses.replace(base, n_layers=2 * len(base.pattern))
    shape = ShapeSpec("t", 32, 8, mode)
    rules = ShardingRules.for_mesh(DEBUG)
    rc = RunConfig(q_chunk=8, kv_chunk=8, loss_chunk=8, mamba_chunk=8,
                   rwkv_chunk=8, microbatch=2 if mode == "train" else 0)
    got = dr.account(cfg, shape, rules, rc)
    flops, colls, _, nb = dr._trace(cfg, shape, rules, rc, mode,
                                 opt_cfg=AdamWConfig(), serve_dtype=None,
                                 train_lowmem=False)
    assert got["flops_per_dev"] == flops > 0
    assert got["collectives"] == colls
    assert {k: v for k, v in got["bytes_per_dev"].items()
            if k != "total"} == nb


def test_hillclimb_records_the_port_accounting(debug_mesh, monkeypatch,
                                               tmp_path):
    """The smollm-train cell's first two variants on the (4, 2) mesh."""
    cell = dict(hillclimb.CELLS["smollm-train"])
    cell["variants"] = cell["variants"][:2]
    monkeypatch.setattr(hillclimb, "CELLS", {"smollm-train": cell})
    hillclimb.main(["--cell", "smollm-train", "--out",
                    str(tmp_path / "h.json")])
    recs = json.loads((tmp_path / "h.json").read_text())
    assert [r["variant"] for r in recs] == ["baseline", "causal_skip"]
    assert all(r["status"] == "ok" and r["hypothesis"] for r in recs)
    assert "against the baseline" in recs[1]["port_accounting"]
    # causal block skipping trims the attention's FLOPs, not collectives
    assert recs[1]["flops_per_dev"] < recs[0]["flops_per_dev"]
    assert recs[1]["collectives"] == recs[0]["collectives"]
