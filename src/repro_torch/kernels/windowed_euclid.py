"""K5 wrapper: the z-normalized windowed squared distance (the distance
profile that subsequence matching brute-forces).

Replaces the Pallas kernel
``repro/kernels/windowed_euclid.py::windowed_euclid_pallas`` with
``csrc/windowed_euclid.cu``.  Bound on the card: operations (2m flops
per (query, window); the scan shape Q = 8, 2048 x 3600, m = 240,
stride 4 is 6.61 GFLOP against 84.6 MB).  Design: one block per (row,
tile of window starts) with the row's slab in shared memory, stored
phase-major so that a warp's reads are free of bank conflicts at any
stride, read once for all queries; several windows per thread, chosen
from the shape; per-window statistics in two passes, so an offset row
does not cancel (see the source).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._lib import CudaKernel, check_cuda, on_cpu, ptr

KERNEL = CudaKernel("windowed_euclid", "repro_windowed_euclid",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
                    + [ctypes.c_int] * 2)

EPS = 1e-12          # as core/normalize.py::znormalize


def n_windows(T: int, m: int, stride: int) -> int:
    """Number of length-m windows of a length-T series at ``stride``."""
    if m > T:
        raise ValueError(f"window m={m} longer than series T={T}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    return (T - m) // stride + 1


def windowed_euclid(x, q, stride: int = 1):
    """(N, T) raw rows vs (m,) or (Q, m) z-normalized queries -> (N, S)
    or (Q, N, S) f32 squared distances to every z-normalized window,
    S = (T - m) // stride + 1.

    CPU tensors take the plain version; CUDA tensors (f32, contiguous)
    launch the kernel."""
    squeeze = q.ndim == 1
    if squeeze:
        q = q[None, :]
    if x.ndim != 2 or q.ndim != 2:
        raise ValueError(f"windowed_euclid: x {tuple(x.shape)} vs q "
                         f"{tuple(q.shape)}")
    (n, t), (nq, m) = x.shape, q.shape
    s = n_windows(t, m, stride)
    if on_cpu("windowed_euclid", x, q):
        out = ref.windowed_euclid_ref(x, q, stride)
    else:
        dev = check_cuda("windowed_euclid", x, q)
        if x.dtype != torch.float32 or q.dtype != torch.float32:
            raise TypeError(f"windowed_euclid: kernel takes f32, got "
                            f"{x.dtype} and {q.dtype}")
        out = torch.empty((nq, n, s), dtype=torch.float32, device=dev)
        if out.numel():
            KERNEL.launch(dev, ptr(x), ptr(q), ptr(out), n, t, nq, m, stride)
    return out[0] if squeeze else out
