"""Compatibility shim: ``SSaxIndex`` / ``ndtri_np`` under their old
import path.  The index lives in :mod:`repro_torch.index`
(:class:`repro_torch.index.SeriesIndex` serves all four encoders)."""

from __future__ import annotations

from repro_torch.index.features import gauss_breaks as _gauss_breaks  # noqa: F401
from repro_torch.index.features import ndtri_np  # noqa: F401
from repro_torch.index.legacy import SSaxIndex  # noqa: F401
from repro_torch.index.tree import TreeNode as _Node  # noqa: F401

__all__ = ["SSaxIndex", "ndtri_np"]
