"""K3 wrapper: the SAX MINDIST^2 sweep.

Replaces the Pallas kernel ``repro/kernels/sax_dist.py::sax_dist_pallas``
with ``csrc/sax_dist.cu``.  Bound on the card: bytes (W*4 symbol bytes
per candidate, 192 B at W=48).  Design: one thread per candidate
gathering from the query's (W, A) table in shared memory; a table too
large for shared memory (up to 384 KB at W=96, A=1024) is read through
L2 instead of being refused.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._lib import CudaKernel, check_cuda, on_cpu, ptr

KERNEL = CudaKernel("sax_dist", "repro_sax_dist",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int64]
                    + [ctypes.c_int] * 2)
MAX_W = 453          # 128 staged rows of W int32 fill a block's 227 KB


def sax_dist(symbols, query_table):
    """Squared SAX MINDIST sweep: (N, W) x (W, A) -> (N,) f32, unscaled.

    CPU tensors take the plain version; CUDA tensors (int32 symbols, f32
    table, contiguous) launch the kernel."""
    if symbols.ndim != 2 or query_table.ndim != 2 or \
            query_table.shape[0] != symbols.shape[1]:
        raise ValueError(f"sax_dist: symbols {tuple(symbols.shape)} vs "
                         f"table {tuple(query_table.shape)}")
    if on_cpu("sax_dist", symbols, query_table):
        return ref.sax_dist_ref(symbols, query_table)
    dev = check_cuda("sax_dist", symbols, query_table)
    if symbols.dtype != torch.int32 or query_table.dtype != torch.float32:
        raise TypeError(f"sax_dist: kernel takes int32 symbols and an f32 "
                        f"table, got {symbols.dtype} and {query_table.dtype}")
    (n, w), a = symbols.shape, query_table.shape[1]
    if w > MAX_W or a == 0:
        raise ValueError(f"sax_dist: kernel takes 0 < W <= {MAX_W} and "
                         f"A > 0, got W={w}, A={a}")
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        KERNEL.launch(dev, ptr(symbols), ptr(query_table), ptr(out), n, w, a)
    return out
