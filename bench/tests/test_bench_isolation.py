"""Nothing under bench/ imports JAX, jaxlib, flax or the JAX package
``repro``; top-level names are compared whole, so ``repro_torch``
passes."""

import subprocess
import sys

from bench import isolation, manifest


def test_no_forbidden_import_in_the_sources():
    assert isolation.forbidden_imports(manifest.HERE) == []


def test_top_level_names_are_compared_whole():
    mods = ["repro_torch", "repro_torch.core", "jaxtyping", "reprox",
            "numpy"]
    assert isolation.forbidden_loaded(mods) == []
    assert isolation.forbidden_loaded(mods + ["repro.core", "jax",
                                              "jaxlib.xla", "flax"]) == [
        "flax", "jax", "jaxlib.xla", "repro.core"]


def test_loading_the_harness_loads_no_forbidden_module():
    code = ("import sys; sys.path[0:0] = [{root!r}, {src!r}]\n"
            "import bench.cell, bench.control, bench.systems.match_service\n"
            "from bench import manifest\n"
            "b = manifest.load()\n"
            "for m in b['per_layer']: manifest.module('metrics', m['name'])\n"
            "import repro_torch.service, repro_torch.core.distributed\n"
            "from bench.isolation import forbidden_loaded\n"
            "print(forbidden_loaded())\n").format(
                root=str(manifest.ROOT), src=str(manifest.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_that_loads_a_forbidden_module_is_refused():
    """The run-time check: a module of a forbidden top-level name that
    appears during a run stops it before any result."""
    import types

    import pytest

    from bench import cell
    sizes = {"corpus": {"n": 600, "chunk": 512}, "pool": 32, "clients": 4,
             "session": {"window_s": 0.002, "max_batch": 4}}

    def load_flax(system):
        sys.modules["flax"] = types.ModuleType("flax")
    try:
        with pytest.raises(RuntimeError, match="flax"):
            cell.run(manifest.load()["workloads"][0]["name"], 3, 0.2, False,
                     device="cpu", sizes=sizes, wrap=load_flax)
    finally:
        sys.modules.pop("flax", None)
