"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and its entry points
run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the port, the smoke script and the rank functions of the multi-process
# matching tests, which run without JAX
FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "dist_match_workers.py",
    ROOT / "tests" / "dist_service_workers.py"]


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_importing_every_module_loads_neither_jax_nor_reference():
    mods = [".".join(p.relative_to(PORT.parent).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(" + repr(mods) + "))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(mods) >= 20


def test_engine_defaults_to_the_card():
    from repro_torch.core import MatchEngine, make_technique
    from repro_torch.core.matching import RawStore
    D = np.zeros((4, 480), np.float32)
    enc = make_technique("sax", T=480, W=24)
    if torch.cuda.is_available():
        assert MatchEngine(enc, RawStore.ssd(D)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            MatchEngine(enc, RawStore.ssd(D))
    assert MatchEngine(enc, RawStore.ssd(D), device="cpu").device.type == \
        "cpu"


@pytest.mark.parametrize("argv", [["--dryrun"], ["--dryrun", "--subseq"],
                                  ["--dryrun", "--index", "--explain"]])
def test_launcher_defaults_to_the_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    from repro_torch.launch.match import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


@pytest.mark.parametrize("argv", [["--dryrun"],
                                  ["--dryrun", "--replicas", "2"]])
def test_serve_launcher_defaults_to_the_card(argv):
    """The service launcher builds its engine on ``make_mesh(1,
    --device)``: without a card the default raises, never falling back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    from repro_torch.launch.serve_match import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


def test_selfjoin_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    from repro_torch.launch.match import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--dryrun", "--selfjoin"])


def test_store_and_subseq_default_to_the_card():
    from repro_torch.core import make_technique
    from repro_torch.store import SymbolicStore
    from repro_torch.subseq import SubseqEngine, WindowView
    enc = make_technique("sax", T=240, W=24)
    D = np.zeros((2, 480), np.float32)
    if torch.cuda.is_available():
        view = WindowView(enc, D)
        assert view.device.type == SubseqEngine(view).device.type == "cuda"
        assert SymbolicStore(enc).device.type == "cuda"
    else:
        for make in (lambda: WindowView(enc, D), lambda: SymbolicStore(enc)):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    view = WindowView(enc, D, device="cpu")
    assert SubseqEngine(view).device.type == "cpu"


def test_open_and_make_engine_default_to_the_card(tmp_path):
    """A reopened snapshot and the launcher's engine run on the card
    unless the caller asks for the CPU: without a card they raise."""
    from repro_torch.core import make_technique
    from repro_torch.launch.match import make_engine
    from repro_torch.store import SymbolicStore
    D = np.zeros((4, 480), np.float32)
    enc = make_technique("sax", T=480, W=48)
    SymbolicStore.from_rows(enc, D, device="cpu").save(str(tmp_path))
    makers = (lambda: SymbolicStore.open(str(tmp_path)),
              lambda: make_engine("sax", D))
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    assert SymbolicStore.open(str(tmp_path), device="cpu").device.type == \
        "cpu"
    assert make_engine("sax", D, device="cpu").device.type == "cpu"


def test_wrappers_never_guess_a_route():
    """A wrapper runs the plain version only for tensors all on the CPU
    and the kernel only for tensors all on CUDA; anything else raises."""
    from repro_torch.kernels import ops
    meta = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError):
        ops.euclid_batch(meta, torch.zeros(8))
    with pytest.raises(ValueError):
        ops.paa_segments(meta, 4)
    with pytest.raises(ValueError):
        ops.windowed_euclid(meta, torch.zeros(4))


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """Copied alone into an empty directory, the script exits nonzero and
    prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_train_launcher_defaults_to_the_card():
    """The training launcher keeps its state on ``--device`` (cuda by
    default): without a card it raises, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--steps", "1", "--batch", "2", "--seq", "16"])


def test_train_state_defaults_to_the_card():
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import tree_leaves_with_path
    from repro_torch.train import init_train_state, train_state_from_reference
    cfg = reduced(get_config("qwen3-0.6b"))
    if torch.cuda.is_available():
        st = init_train_state(cfg, 0)
        assert {a.device.type for _, a in tree_leaves_with_path(st)} == \
            {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            init_train_state(cfg, 0)
        with pytest.raises(RuntimeError, match="CUDA"):
            train_state_from_reference(cfg, {})
    st = init_train_state(cfg, 0, device="cpu")
    assert {a.device.type for _, a in tree_leaves_with_path(st)} == {"cpu"}
