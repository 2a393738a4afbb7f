"""Build, load and launch the port's hand-written CUDA kernels.

Every source in ``csrc/`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with
``ctypes``.  The build runs at first use, one ``nvcc`` per source, all
started together, then one link.  It lands in
``build/kernels/<hash>/`` at the repository root, where ``<hash>``
covers the sources and the flags: an unchanged tree reuses its library
and a changed source builds anew.  Nothing here runs at import time.

Each C entry point launches on the stream it is given and returns the
``cudaError_t`` of the launch; :class:`CudaKernel` raises if it is not
zero and counts the launches that went through.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}           # "lib" -> ctypes.CDLL, "build_s" -> seconds


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                       "kernels build only where the CUDA toolkit is")


def _sources() -> list:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists.
    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library in ``build.log``.  Processes that
    build at once (the ranks of one node) take a file lock beside the
    build directory: one compiles, the others wait and load its
    library."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            _compile(so)
    return so


def _compile(so: Path) -> None:
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=so.parent))
    try:
        cus = [p for p in _sources() if p.suffix == ".cu"]
        objs = [tmp / (p.stem + ".o") for p in cus]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cus, objs)]
        logs = []
        failed = []
        for src, p in zip(cus, procs):
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n"
                               + "\n".join(logs))
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp / LIB_NAME), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        (so.parent / "build.log").write_text("\n".join(logs))
        os.replace(tmp / LIB_NAME, so)     # atomic: readers see all or none
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    with _lock:
        if "lib" not in _loaded:
            t0 = time.perf_counter()
            so = build()
            _loaded["build_s"] = time.perf_counter() - t0
            _loaded["lib"] = ctypes.CDLL(str(so))
        return _loaded["lib"]


def build_seconds() -> float:
    """Seconds the first :func:`load` spent building (or finding) the
    library in this process."""
    load()
    return _loaded["build_s"]


class CudaKernel:
    """The C entry points of one kernel plus its one launch count.

    ``argtypes`` lists the entry's arguments without the trailing stream
    pointer, which every entry takes and :meth:`launch` supplies.
    ``more`` maps further entry points of the same kernel to their
    argtypes; ``launch(..., symbol=)`` picks one.  ``launches`` counts
    successful launches of every entry; only :meth:`launch` adds to it,
    under a lock, so that launches from concurrent threads (a service's
    dispatcher, replica workers and ingest writer) lose no count."""

    def __init__(self, name: str, symbol: str, argtypes: list,
                 more: dict | None = None):
        self.name = name
        self.symbol = symbol
        self.argtypes = {s: list(a) + [ctypes.c_void_p]
                         for s, a in {symbol: argtypes, **(more or {})}
                         .items()}
        self.launches = 0
        self._count_lock = threading.Lock()
        self._fns: dict = {}

    def _bind(self, symbol: str):
        fn = getattr(load(), symbol)
        fn.argtypes = self.argtypes[symbol]
        fn.restype = ctypes.c_int
        self._fns[symbol] = fn
        return fn

    def launch(self, device: torch.device, *args,
               symbol: str | None = None) -> None:
        symbol = symbol or self.symbol
        fn = self._fns.get(symbol) or self._bind(symbol)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err:
            raise RuntimeError(f"CUDA kernel {self.name} ({symbol}) failed "
                               f"to launch: cudaError_t {err}")
        with self._count_lock:
            self.launches += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors contiguous and on one CUDA device; returns it."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return dev


def on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs),
    False when all are on CUDA (the kernel runs); anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"{name}: tensors must all be on the CPU or all on "
                     f"one CUDA device, got {sorted(kinds)}")
