"""K2 wrapper: the sSAX cell^2 sweep (Eq. 20, max form).

Replaces the Pallas kernel
``repro/kernels/ssax_dist.py::ssax_dist_pallas`` with
``csrc/ssax_dist.cu``.  Bound on the card: for one query about even
between bytes ((L + W)*4 symbol bytes per candidate, 232 B at L=10,
W=48) and FP32 issue (five instructions per cell); a batch of queries
reads the symbols once, so it is bound by operations.  Design:
persistent blocks stage each symbol tile with ``cp.async`` while the
previous one computes, turn each symbol into its gather offset once, and
sweep every query of the batch against the tile with the queries'
tables in shared memory.
Two entries launch the one kernel under one counter:

  * :func:`ssax_dist`       -- one query, (N,) out;
  * :func:`ssax_dist_batch` -- Q queries in one launch, (Q, N) out.

Each query's sum is bitwise the same through either entry and in any
batch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._lib import CudaKernel, check_cuda, on_cpu, ptr

KERNEL = CudaKernel(
    "ssax_dist", "repro_ssax_dist",
    [ctypes.c_void_p] * 7 + [ctypes.c_int64] + [ctypes.c_int] * 4,
    more={"repro_ssax_dist_batch":
          [ctypes.c_void_p] * 7 + [ctypes.c_int64] + [ctypes.c_int] * 5})
MAX_LW = 453         # 64 rows of L + W int32, staged and as offsets: 227 KB


def _check(name, seas_syms, res_syms, t1, t2, u1, u2, batched: bool):
    """Shapes first (both routes), then on the card dtypes and sizes.
    Returns (on_cpu, device)."""
    n, l = seas_syms.shape
    w = res_syms.shape[1]
    lead = tuple(t1.shape[:1]) if batched else ()
    if res_syms.shape[0] != n or t1.ndim != len(lead) + 2 or \
            t1.shape != t2.shape or u1.shape != u2.shape or \
            tuple(u1.shape[:len(lead)]) != lead or \
            t1.shape[len(lead)] != l or u1.shape[len(lead)] != w:
        raise ValueError(f"{name}: shapes disagree: seas "
                         f"{tuple(seas_syms.shape)}, res "
                         f"{tuple(res_syms.shape)}, t {tuple(t1.shape)}, "
                         f"u {tuple(u1.shape)}")
    args = (seas_syms, res_syms, t1, t2, u1, u2)
    if on_cpu(name, *args):
        return True, None
    dev = check_cuda(name, *args)
    if seas_syms.dtype != torch.int32 or res_syms.dtype != torch.int32 or \
            any(t.dtype != torch.float32 for t in (t1, t2, u1, u2)):
        raise TypeError(f"{name}: kernel takes int32 symbols and f32 "
                        f"tables")
    a_s, a_r = t1.shape[-1], u1.shape[-1]
    if (l | 1) + (w | 1) > MAX_LW or min(l, w, a_s, a_r) == 0:
        raise ValueError(f"{name}: kernel takes L + W <= {MAX_LW} and "
                         f"nonempty tables, got L={l}, W={w}")
    return False, dev


def ssax_dist(seas_syms, res_syms, t1, t2, u1, u2):
    """Squared sSAX sweep: (N, L)/(N, W) + four tables -> (N,) f32,
    unscaled.

    CPU tensors take the plain version; CUDA tensors (int32 symbols, f32
    tables, contiguous) launch the kernel."""
    args = (seas_syms, res_syms, t1, t2, u1, u2)
    cpu, dev = _check("ssax_dist", *args, batched=False)
    if cpu:
        return ref.ssax_dist_ref(*args)
    n, l = seas_syms.shape
    w = res_syms.shape[1]
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        KERNEL.launch(dev, *(ptr(t) for t in args), ptr(out), n, l, w,
                      t1.shape[1], u1.shape[1])
    return out


def ssax_dist_batch(seas_syms, res_syms, t1, t2, u1, u2):
    """Squared sSAX sweep for Q queries in one launch: (N, L)/(N, W)
    symbols, (Q, L, A_seas) ``t1``/``t2`` and (Q, W, A_res) ``u1``/``u2``
    -> (Q, N) f32, unscaled; row q equals :func:`ssax_dist` on query q's
    tables, bitwise.

    CPU tensors take the plain version; CUDA tensors (int32 symbols, f32
    tables, contiguous) launch the kernel once."""
    args = (seas_syms, res_syms, t1, t2, u1, u2)
    cpu, dev = _check("ssax_dist_batch", *args, batched=True)
    if cpu:
        return ref.ssax_dist_batch_ref(*args)
    n, l = seas_syms.shape
    nq, w = t1.shape[0], res_syms.shape[1]
    out = torch.empty((nq, n), dtype=torch.float32, device=dev)
    if out.numel():
        KERNEL.launch(dev, *(ptr(t) for t in args), ptr(out), n, nq, l, w,
                      t1.shape[2], u1.shape[2],
                      symbol="repro_ssax_dist_batch")
    return out
