"""K1 wrapper: batched squared Euclidean distance, the verification and
brute-force kernel.

Replaces the Pallas kernel ``repro/kernels/euclid.py::euclid_pallas``
with ``csrc/euclid.cu``.  Bound on the card: bytes (each input element
read once, three flops).  Two entries share one per-pair device
function whose reduction order is fixed by T and the dtype alone, so
every route gives bit-identical distances (see the source for the
argument):

  * :func:`euclid_batch`  -- all pairs, (N, T) rows vs (Q, T) queries;
    the brute force.
  * :func:`euclid_gather` -- each query against its own candidate rows,
    gathered from the union of a verification round; one launch per
    round.

Both count their launches under the one counter of ``KERNEL``
("euclid").
"""

from __future__ import annotations

import ctypes
from contextlib import nullcontext

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._lib import CudaKernel, check_cuda, on_cpu, ptr
from repro_torch.obs.trace import span

KERNEL = CudaKernel(
    "euclid", "repro_euclid",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_int],
    more={"repro_euclid_gather":
          [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [ctypes.c_int]})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_QUERY_BYTES = 232448     # a block's shared memory on sm_90: one query


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its data is 16-byte aligned, else an aligned
    copy: the kernel's vector form reads 16-byte chunks, and alignment
    must never pick the form."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_kernel_inputs(name: str, x, q) -> torch.device:
    dev = check_cuda(name, x, q)
    if x.dtype not in _DTYPES or q.dtype != x.dtype:
        raise TypeError(f"{name}: kernel takes f32 or bf16, got "
                        f"{x.dtype} and {q.dtype}")
    if q.shape[1] * q.element_size() > MAX_QUERY_BYTES:
        raise ValueError(f"{name}: a query of T = {q.shape[1]} "
                         f"{q.dtype} exceeds the kernel's "
                         f"{MAX_QUERY_BYTES} bytes of shared memory")
    return dev


def launch_gather(rows, q, gather, out) -> None:
    """Launch the gathered kernel on checked, aligned device tensors
    (no host work beyond the launch: a CUDA graph may capture it)."""
    (u, t), (nq, b) = rows.shape, gather.shape
    KERNEL.launch(rows.device, ptr(rows), ptr(q), ptr(gather), ptr(out),
                  u, nq, b, t, _DTYPES[rows.dtype],
                  symbol="repro_euclid_gather")


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
        dev = _check_kernel_inputs("euclid_batch", x, q)
        (n, t), nq = x.shape, q.shape[0]
        out = torch.empty((nq, n), dtype=torch.float32, device=dev)
        if out.numel():
            x, q = _aligned(x), _aligned(q)
            KERNEL.launch(dev, ptr(x), ptr(q), ptr(out), n, nq, t,
                          _DTYPES[x.dtype])
    return out[0] if squeeze else out


def _check_gather(gather, n_rows: int, n_q: int):
    """``gather`` as an int64 (n_q, B) index into ``n_rows`` rows, or
    raise.  A numpy array or CPU tensor is checked on the host; a CUDA
    tensor with one reduction (a synchronisation)."""
    if isinstance(gather, np.ndarray):
        gather = torch.from_numpy(gather)
    if not isinstance(gather, torch.Tensor):
        raise TypeError(f"euclid_gather: gather must be an array or a "
                        f"tensor, got {type(gather).__name__}")
    if gather.dtype != torch.int64:
        raise TypeError(f"euclid_gather: gather must be int64, got "
                        f"{gather.dtype}")
    if gather.ndim != 2 or gather.shape[0] != n_q:
        raise ValueError(f"euclid_gather: gather {tuple(gather.shape)} "
                         f"for {n_q} queries")
    if gather.numel():
        lo, hi = torch.aminmax(gather)
        # a CUDA gather's bounds come back in two blocking copies
        with span("wait") if gather.is_cuda else nullcontext():
            lo, hi = int(lo), int(hi)
        if lo < 0 or hi >= n_rows:
            raise ValueError(f"euclid_gather: gather spans [{lo}, {hi}], "
                             f"outside the {n_rows} rows")
    return gather


def euclid_gather(rows, q, gather):
    """(U, T) rows, (Qa, T) queries and a (Qa, B) int64 gather ->
    (Qa, B) f32: ``out[a, b]`` is the squared distance of ``q[a]`` to
    ``rows[gather[a, b]]``.

    CPU rows and queries take the plain version.  CUDA ones (f32 or
    bf16, of one type, contiguous) launch the kernel once; the gather
    may come from the host (numpy or a CPU tensor: checked there, then
    copied once) or lie on the rows' device."""
    if rows.ndim != 2 or q.ndim != 2 or q.shape[1] != rows.shape[1]:
        raise ValueError(f"euclid_gather: rows {tuple(rows.shape)} vs q "
                         f"{tuple(q.shape)}")
    gather = _check_gather(gather, rows.shape[0], q.shape[0])
    if on_cpu("euclid_gather", rows, q):
        return ref.euclid_gather_ref(rows, q, gather.cpu())
    dev = _check_kernel_inputs("euclid_gather", rows, q)
    gather = _aligned(gather.to(dev).contiguous())
    out = torch.empty(tuple(gather.shape), dtype=torch.float32, device=dev)
    if out.numel():
        launch_gather(_aligned(rows), _aligned(q), gather, out)
    return out
