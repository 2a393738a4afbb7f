"""K4 wrapper: PAA segment means, the encoders' front end.

Replaces the Pallas kernel ``repro/kernels/paa.py::paa_pallas`` with
``csrc/paa.cu``.  Bound on the card: bytes (each input element read
once, one add); the 1M x 960 f32 encode moves about 4 GB.  Design: one
thread per output segment summing its E = T/W contiguous values in f32,
so a warp covers one contiguous stretch of the input.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._lib import CudaKernel, check_cuda, on_cpu, ptr

KERNEL = CudaKernel("paa", "repro_paa",
                    [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2
                    + [ctypes.c_int])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paa_segments(x, n_segments: int):
    """(N, T) -> (N, W) f32 segment means; W must divide T.

    CPU tensors take the plain version; CUDA tensors (f32 or bf16,
    contiguous) launch the kernel."""
    if x.ndim != 2:
        raise ValueError(f"paa_segments takes (N, T), got {tuple(x.shape)}")
    n, t = x.shape
    if n_segments <= 0 or t % n_segments:
        raise ValueError(f"W={n_segments} must divide T={t}")
    if on_cpu("paa_segments", x):
        return ref.paa_ref(x, n_segments)
    dev = check_cuda("paa_segments", x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"paa_segments: kernel takes f32 or bf16, got "
                        f"{x.dtype}")
    out = torch.empty((n, n_segments), dtype=torch.float32, device=dev)
    if out.numel():
        KERNEL.launch(dev, ptr(x), ptr(out), n * n_segments,
                      t // n_segments, _DTYPES[x.dtype])
    return out
