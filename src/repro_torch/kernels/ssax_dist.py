"""K2 wrapper: the sSAX cell^2 sweep (Eq. 20, max form).

Replaces the Pallas kernel
``repro/kernels/ssax_dist.py::ssax_dist_pallas`` with
``csrc/ssax_dist.cu``.  Bound on the card: bytes ((L + W)*4 symbol bytes
per candidate, 232 B at L=10, W=48, against 2,400 flops).  Design: one
thread per candidate, the four query tables in shared memory, the
(L, W) cross in registers, chunk by chunk.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._lib import CudaKernel, check_cuda, on_cpu, ptr

KERNEL = CudaKernel("ssax_dist", "repro_ssax_dist",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int64]
                    + [ctypes.c_int] * 4)
MAX_LW = 453         # 128 staged rows of L + W int32 fill a block's 227 KB


def ssax_dist(seas_syms, res_syms, t1, t2, u1, u2):
    """Squared sSAX sweep: (N, L)/(N, W) + four tables -> (N,) f32,
    unscaled.

    CPU tensors take the plain version; CUDA tensors (int32 symbols, f32
    tables, contiguous) launch the kernel."""
    n, l = seas_syms.shape
    w = res_syms.shape[1]
    if res_syms.shape[0] != n or t1.shape != t2.shape or \
            u1.shape != u2.shape or t1.shape[0] != l or u1.shape[0] != w:
        raise ValueError("ssax_dist: shapes disagree: seas "
                         f"{tuple(seas_syms.shape)}, res "
                         f"{tuple(res_syms.shape)}, t {tuple(t1.shape)}, "
                         f"u {tuple(u1.shape)}")
    args = (seas_syms, res_syms, t1, t2, u1, u2)
    if on_cpu("ssax_dist", *args):
        return ref.ssax_dist_ref(*args)
    dev = check_cuda("ssax_dist", *args)
    if seas_syms.dtype != torch.int32 or res_syms.dtype != torch.int32 or \
            any(t.dtype != torch.float32 for t in (t1, t2, u1, u2)):
        raise TypeError("ssax_dist: kernel takes int32 symbols and f32 "
                        "tables")
    a_s, a_r = t1.shape[1], u1.shape[1]
    if (l | 1) + (w | 1) > MAX_LW or min(l, w, a_s, a_r) == 0:
        raise ValueError(f"ssax_dist: kernel takes L + W <= {MAX_LW} and "
                         f"nonempty tables, got L={l}, W={w}")
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        KERNEL.launch(dev, *(ptr(t) for t in args), ptr(out), n, l, w,
                      a_s, a_r)
    return out
