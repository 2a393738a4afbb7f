"""One factory for the paper's four techniques at the repo's standard
alphabet budget (SAX 64; sSAX 16/32; tSAX 64/32; stSAX 16/16/32), so the
launchers and benchmarks construct encoders in exactly one place.

``from_reference`` and ``rep_from_numpy`` carry the JAX package's state
across: an encoder from its dataclass fields, and a representation from
its numpy arrays.  Encoder parameters and the symbolic representation
are this system's state; it has no model weights."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.sax import SAX
from repro_torch.core.ssax import SSAX
from repro_torch.core.stsax import STSAX
from repro_torch.core.tsax import TSAX

TECHNIQUES = ("sax", "ssax", "tsax", "stsax")
ENCODERS = {cls.__name__: cls for cls in (SAX, SSAX, TSAX, STSAX)}


def make_technique(name: str, *, T: int, W: int, L: int = 10,
                   r2_season: float = 0.7,
                   r2_trend: Optional[float] = None):
    """Build encoder ``name`` for series length ``T`` with ``W`` segments.

    ``r2_season`` is the deterministic-component strength; ``r2_trend``
    defaults to it for tSAX (there the trend IS the component) and to a
    mild 0.2 for stSAX's trend share.
    """
    if name == "sax":
        return SAX(T=T, W=W, A=64)
    if name == "ssax":
        return SSAX(T=T, W=W, L=L, A_seas=16, A_res=32,
                    r2_season=r2_season)
    if name == "tsax":
        return TSAX(T=T, W=W, A_tr=64, A_res=32,
                    r2_trend=r2_season if r2_trend is None else r2_trend)
    if name == "stsax":
        return STSAX(T=T, W=W, L=L, A_tr=16, A_seas=16, A_res=32,
                     r2_trend=0.2 if r2_trend is None else r2_trend,
                     r2_season=r2_season)
    raise ValueError(f"unknown technique {name!r}; options {TECHNIQUES}")


def from_reference(name: str, fields: dict):
    """The port's encoder for a JAX-package encoder: ``name`` is its class
    name (``type(enc).__name__``), ``fields`` its
    ``dataclasses.asdict``."""
    if name not in ENCODERS:
        raise ValueError(f"unknown encoder class {name!r}; options "
                         f"{sorted(ENCODERS)}")
    return ENCODERS[name](**fields)


def rep_from_numpy(rep, device):
    """A JAX-package representation (an array, or a tuple of arrays, as
    its ``encode`` returns) as tensors on ``device``, dtypes kept."""
    if isinstance(rep, tuple):
        return tuple(rep_from_numpy(r, device) for r in rep)
    return torch.tensor(np.asarray(rep), device=device)
