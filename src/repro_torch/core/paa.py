"""Piecewise Aggregate Approximation (Eq. 5) and its distance (Eq. 9)."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.paa import paa_segments


def paa(x, n_segments: int):
    """x: (..., T) -> f32 segment means (..., W).  W must divide T.

    Runs through ``kernels.paa.paa_segments``: the K4 kernel for a CUDA
    tensor, its plain version for a CPU tensor."""
    T = x.shape[-1]
    lead = x.shape[:-1]
    out = paa_segments(x.reshape(-1, T).contiguous(), n_segments)
    return out.reshape(*lead, n_segments)


def paa_distance(a, b, T: int):
    """d_PAA (Eq. 9): sqrt(T/W) * ||a - b||_2 along the last axis."""
    W = a.shape[-1]
    return math.sqrt(T / W) * torch.sqrt((a - b).square().sum(-1))
