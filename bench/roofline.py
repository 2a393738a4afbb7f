"""Frozen roofline arithmetic: H100 peaks and the work each kernel call
needs, from its shapes.

The counts are those of ``chip_smoke.py``'s kernel phase (``bound_ms``
and the byte and operation counts beside each kernel there): each input
byte read once, each output byte written once, for the work that the
calls' inputs need, counted from the program's counters and never from
the kernel's launches.  A later kernel that does the same work, in one
launch or in many, reads the same bound.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM, f32 outside the tensor cores


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Least seconds the card could take: bytes over bandwidth or
    operations over f32 peak, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS_PER_S)


def k1_work(pairs: int, T: int) -> tuple:
    """K1 (``euclid.cu``), gathered verification: ``pairs`` (query,
    candidate) pairs of length ``T`` f32.  Each pair reads its candidate
    row and its gather index and writes one distance; three operations
    (subtract, multiply, add) per element.  Returns (bytes, operations)."""
    return pairs * (T * 4 + 8 + 4), 3 * pairs * T


def k2_work(sweeps: int, queries: int, n: int, L: int, W: int,
            a_seas: int, a_res: int) -> tuple:
    """K2 (``ssax_dist.cu``): ``sweeps`` engine sweeps over ``n`` rows of
    (L + W) int32 symbols, ``queries`` queries in all.  A sweep reads the
    symbols once, whatever the queries in it; each query reads its four
    tables and writes n distances; six operations per (query, row, l, w)
    cell."""
    n_bytes = (sweeps * n * (L + W) * 4 + queries * n * 4
               + queries * 2 * (L * a_seas + W * a_res) * 4)
    return n_bytes, 6 * queries * n * L * W


def share_pct(work: tuple, device_s: float):
    """Roofline share in percent of kernel time ``device_s`` for (bytes,
    operations) ``work``; None where the kernel did not run."""
    if not device_s or device_s <= 0:
        return None
    n_bytes, n_ops = work
    if n_bytes <= 0 and n_ops <= 0:
        return None
    return 100.0 * bound_s(n_bytes, n_ops) / device_s
