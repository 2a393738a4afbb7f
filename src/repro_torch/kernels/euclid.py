"""K1 wrapper: batched squared Euclidean distance, the verification
kernel.

Replaces the Pallas kernel ``repro/kernels/euclid.py::euclid_pallas``
with ``csrc/euclid.cu``.  Bound on the card: bytes (each input element
read once, three flops); one verification batch (256 x 960 f32, one
query) moves about 1 MB, so a launch is launch-bound.  Design: one warp
per (query, row) pair with a reduction order fixed by T alone, so every
route that calls this kernel gives bit-identical distances (see the
source for the argument).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._lib import CudaKernel, check_cuda, on_cpu, ptr

KERNEL = CudaKernel("euclid", "repro_euclid",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
                    + [ctypes.c_int])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def euclid_batch(x, q):
    """(N, T) vs (T,) or (Q, T) -> (N,) or (Q, N) f32 squared distances.

    CPU tensors take the plain version; CUDA tensors (f32 or bf16, both
    of one type, contiguous) launch the kernel."""
    squeeze = q.ndim == 1
    if squeeze:
        q = q[None, :]
    if x.ndim != 2 or q.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"euclid_batch: x {tuple(x.shape)} vs q "
                         f"{tuple(q.shape)}")
    if on_cpu("euclid_batch", x, q):
        out = torch.stack([ref.euclid_ref(x, qi) for qi in q]) \
            if q.shape[0] else torch.empty((0, x.shape[0]))
    else:
        dev = check_cuda("euclid_batch", x, q)
        if x.dtype not in _DTYPES or q.dtype != x.dtype:
            raise TypeError(f"euclid_batch: kernel takes f32 or bf16, got "
                            f"{x.dtype} and {q.dtype}")
        (n, t), nq = x.shape, q.shape[0]
        out = torch.empty((nq, n), dtype=torch.float32, device=dev)
        if out.numel():
            KERNEL.launch(dev, ptr(x), ptr(q), ptr(out), n, nq, t,
                          _DTYPES[x.dtype])
    return out[0] if squeeze else out
