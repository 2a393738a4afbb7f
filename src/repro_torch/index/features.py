"""Per-encoder feature adapters for the split-tree index.

An adapter maps raw series (or z-normalized windows) to a real-valued
feature matrix and defines two lower bounds of d_ED on it:

* the **weighted bounding-box bound** used to prune subtrees — for any
  member x of a node with box [lo, hi] and query features f(q),

      d_ED(q, x)^2  >=  sum_d w_d * gap_d^2,
      gap_d = max(0, lo_d - f(q)_d, f(q)_d - hi_d);

* the **exact member bound** ``member_lb`` (the Table-2 feature
  distance) used to bound individual leaf members.

Why the weighted sum lower-bounds d_ED per encoder (each term is one of
the paper's proofs, Appendix A):

* SAX — PAA segment means, w = T/W (A.1: PAA projection).
* sSAX — the tiled season-mask difference is exactly (T/L)*|d_sigma|^2
  and is orthogonal to the residual difference (residuals have zero mean
  per phase), whose norm the residual PAA bounds by (T/W)*|d_res|^2.
* tSAX — the trend difference lies in span{1, t} while the least-squares
  residual difference is orthogonal to it; with the scaled slope feature
  u = tan(phi) * sqrt(T * var(t)) the trend term is |du|^2 <= |d_tr|^2
  (the mean component is dropped), w_u = 1.
* stSAX — trend orthogonal to the detrended remainder (A.4), season
  orthogonal to residual within it: all three terms add.

``member_lb`` defaults to the same weighted L2; the season-aware
adapters override it with the tighter Table-2 forms (d_sPAA keeps the
season x residual cross term).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.engine import resolve_device


def ndtri_np(q):
    """Inverse normal CDF (Acklam's rational approximation, |err|<1.2e-8)
    in host float64 numpy, so the tree's split breakpoints are the same
    bits on every machine and in both packages."""
    q = np.asarray(q, np.float64)
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    out = np.empty_like(q)
    lo = q < plow
    hi = q > phigh
    mid = ~(lo | hi)
    if lo.any():
        r = np.sqrt(-2 * np.log(q[lo]))
        out[lo] = (((((c[0] * r + c[1]) * r + c[2]) * r + c[3]) * r + c[4])
                   * r + c[5]) / ((((d[0] * r + d[1]) * r + d[2]) * r
                                   + d[3]) * r + 1)
    if hi.any():
        r = np.sqrt(-2 * np.log(1 - q[hi]))
        out[hi] = -((((((c[0] * r + c[1]) * r + c[2]) * r + c[3]) * r
                      + c[4]) * r + c[5]) /
                    ((((d[0] * r + d[1]) * r + d[2]) * r + d[3]) * r + 1))
    if mid.any():
        r = q[mid] - 0.5
        t = r * r
        out[mid] = (((((a[0] * t + a[1]) * t + a[2]) * t + a[3]) * t
                     + a[4]) * t + a[5]) * r / \
            (((((b[0] * t + b[1]) * t + b[2]) * t + b[3]) * t + b[4]) * t + 1)
    return out


def gauss_breaks(card: int, sd: float) -> np.ndarray:
    """card-quantile breakpoints of N(0, sd) (card - 1 interior points)."""
    qs = np.arange(1, card) / card
    return sd * ndtri_np(qs)


class FeatureAdapter:
    """Feature-space contract the split tree consumes.

    Attributes
    ----------
    T:        series length the bounds are scaled to.
    D:        feature dimensionality.
    weights:  (D,) bounding-box weights (see module docstring).
    sds:      (D,) per-dimension scale for the split breakpoints (only
              affects split balance, never correctness).
    priority: (D,) split-order class per dimension; lower splits first
              (0 = season, then trend, then residual).
    encoder:  the bound encoder, when available — required only by
              ``features`` (precomputed-feature paths run without one).
    device:   where ``features`` runs the encoder's feature map (through
              the K4 PAA kernel on a card); the host receives f32 numpy.
    """

    def __init__(self, T: int, weights, sds, priority, encoder=None,
                 device="cuda"):
        self.T = int(T)
        self.weights = np.asarray(weights, np.float64)
        self.sds = np.asarray(sds, np.float64)
        self.priority = np.asarray(priority, np.int32)
        self.D = int(self.weights.size)
        if not self.sds.shape == self.priority.shape == (self.D,):
            raise ValueError("weights, sds and priority differ in length")
        self.encoder = encoder
        self.device = torch.device(device)

    def _require_encoder(self):
        if self.encoder is None:
            raise TypeError(f"{type(self).__name__} was built without an "
                            "encoder: features must be supplied precomputed")
        return self.encoder

    def _rows(self, rows) -> torch.Tensor:
        self._require_encoder()
        x = torch.as_tensor(np.asarray(rows, np.float32))
        return x.to(resolve_device(self.device))

    def features(self, rows) -> np.ndarray:
        """(N, T) raw rows -> (N, D) float32 features (row-wise map, so
        chunked computation is bit-identical to one-shot): a device map
        (``_device_features``) and host assembly (``_assemble``)."""
        return self._assemble(self._device_features(rows))

    def features_sharded(self, rows, mesh) -> np.ndarray:
        """``features`` sharded row-wise across a device mesh."""
        raise NotImplementedError(
            "features_sharded needs core/distributed.py, which is not "
            "ported yet (ROADMAP queue 1 item 8)")

    def _device_features(self, rows):
        """Pure row-wise map on ``device``: (N, T) raw rows -> feature
        tensors (all lead with the N axis)."""
        raise NotImplementedError

    def _assemble(self, parts) -> np.ndarray:
        """Host assembly of ``_device_features`` output into the (N, D)
        float32 feature matrix (casts / concats / host-f64 transforms
        that must not move onto the device for bit-identity)."""
        raise NotImplementedError

    def member_lb(self, qf: np.ndarray, feats: np.ndarray) -> np.ndarray:
        """Exact feature-distance lower bound of d_ED per member.
        qf: (D,), feats: (M, D) -> (M,) float64."""
        d = np.asarray(feats, np.float64) - np.asarray(qf, np.float64)[None]
        return np.sqrt(np.maximum(np.sum(self.weights * d * d, axis=1), 0.0))


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class SAXFeatures(FeatureAdapter):
    """PAA segment means; d_PAA = sqrt(T/W * |d|^2)."""

    def __init__(self, T: int, W: int, *, sd: float = 1.0, encoder=None,
                 device="cuda"):
        super().__init__(T, [T / W] * W, [sd] * W, [0] * W, encoder, device)
        self.W = int(W)

    def _device_features(self, rows):
        from repro_torch.core.paa import paa
        return paa(self._rows(rows), self.W)

    def _assemble(self, parts) -> np.ndarray:
        return _host(parts).astype(np.float32, copy=False)


class SSAXFeatures(FeatureAdapter):
    """Season mask (L) ++ residual PAA (W); member bound is the exact
    d_sPAA of Table 2 (season x residual cross term kept)."""

    def __init__(self, T: int, L: int, W: int, *, sd_seas: float,
                 sd_res: float, encoder=None, device="cuda"):
        super().__init__(T, [T / L] * L + [T / W] * W,
                         [sd_seas] * L + [sd_res] * W,
                         [0] * L + [1] * W, encoder, device)
        self.L, self.W = int(L), int(W)

    def _device_features(self, rows):
        return self.encoder.features(self._rows(rows))

    def _assemble(self, parts) -> np.ndarray:
        sigma, resbar = parts
        return np.concatenate([_host(sigma).astype(np.float32),
                               _host(resbar).astype(np.float32)], axis=1)

    def member_lb(self, qf, feats):
        """d_sPAA expanded to avoid the L x W cross product:
        T/L*|ds|^2 + T/W*|dr|^2 + 2T/(W*L)*sum(ds)*sum(dr)."""
        feats = np.asarray(feats, np.float64)
        qf = np.asarray(qf, np.float64)
        ds = feats[:, :self.L] - qf[None, :self.L]
        dr = feats[:, self.L:] - qf[None, self.L:]
        t = (self.T / self.L) * np.sum(ds * ds, axis=1) \
            + (self.T / self.W) * np.sum(dr * dr, axis=1) \
            + 2.0 * self.T / (self.W * self.L) * ds.sum(1) * dr.sum(1)
        return np.sqrt(np.maximum(t, 0.0))


def _trend_scale(T: int) -> float:
    from repro_torch.core.tsax import time_variance
    return math.sqrt(T * time_variance(T))


class TSAXFeatures(FeatureAdapter):
    """Scaled trend slope u = tan(phi) * sqrt(T * var(t)) (1 dim, weight
    1) ++ residual PAA (W dims, weight T/W)."""

    def __init__(self, T: int, W: int, *, sd_res: float,
                 r2_trend: float = 0.5, encoder=None, device="cuda"):
        sd_u = math.sqrt(max(r2_trend, 0.05) * T)
        super().__init__(T, [1.0] + [T / W] * W, [sd_u] + [sd_res] * W,
                         [0] + [1] * W, encoder, device)
        self.W = int(W)
        self.scale = _trend_scale(T)

    def _device_features(self, rows):
        return self.encoder.features(self._rows(rows))

    def _assemble(self, parts) -> np.ndarray:
        phi, resbar = parts
        # slope transform stays host-f64: tan in f32 on the device would
        # drift the stored features by ulps vs the incremental path
        u = self.scale * np.tan(_host(phi).astype(np.float64))
        return np.concatenate([u[:, None].astype(np.float32),
                               _host(resbar).astype(np.float32)], axis=1)


class STSAXFeatures(FeatureAdapter):
    """Scaled trend slope (1) ++ season mask (L) ++ residual PAA (W);
    the member bound combines |du|^2 with the d_sPAA season/residual part
    (cross term kept) — each term is one of the paper's component
    bounds, summed by orthogonality (stSAX docstring / A.4)."""

    def __init__(self, T: int, L: int, W: int, *, sd_seas: float,
                 sd_res: float, r2_trend: float = 0.3, encoder=None,
                 device="cuda"):
        sd_u = math.sqrt(max(r2_trend, 0.05) * T)
        super().__init__(T, [1.0] + [T / L] * L + [T / W] * W,
                         [sd_u] + [sd_seas] * L + [sd_res] * W,
                         [1] + [0] * L + [2] * W, encoder, device)
        self.L, self.W = int(L), int(W)
        self.scale = _trend_scale(T)

    def _device_features(self, rows):
        return self.encoder.features(self._rows(rows))

    def _assemble(self, parts) -> np.ndarray:
        phi, sigma, resbar = parts
        u = self.scale * np.tan(_host(phi).astype(np.float64))
        return np.concatenate([u[:, None].astype(np.float32),
                               _host(sigma).astype(np.float32),
                               _host(resbar).astype(np.float32)], axis=1)

    def member_lb(self, qf, feats):
        feats = np.asarray(feats, np.float64)
        qf = np.asarray(qf, np.float64)
        du = feats[:, 0] - qf[0]
        ds = feats[:, 1:1 + self.L] - qf[None, 1:1 + self.L]
        dr = feats[:, 1 + self.L:] - qf[None, 1 + self.L:]
        t = du * du \
            + (self.T / self.L) * np.sum(ds * ds, axis=1) \
            + (self.T / self.W) * np.sum(dr * dr, axis=1) \
            + 2.0 * self.T / (self.W * self.L) * ds.sum(1) * dr.sum(1)
        return np.sqrt(np.maximum(t, 0.0))


def adapter_for(encoder, device="cuda") -> FeatureAdapter:
    """The feature adapter matching one of the paper's four techniques,
    computing features on ``device``."""
    from repro_torch.core import SAX, SSAX, STSAX, TSAX
    if isinstance(encoder, SAX):
        return SAXFeatures(encoder.T, encoder.W, sd=encoder.sd,
                           encoder=encoder, device=device)
    if isinstance(encoder, SSAX):
        return SSAXFeatures(encoder.T, encoder.L, encoder.W,
                            sd_seas=encoder.sd_seas, sd_res=encoder.sd_res,
                            encoder=encoder, device=device)
    if isinstance(encoder, TSAX):
        return TSAXFeatures(encoder.T, encoder.W, sd_res=encoder.sd_res,
                            r2_trend=encoder.r2_trend, encoder=encoder,
                            device=device)
    if isinstance(encoder, STSAX):
        return STSAXFeatures(encoder.T, encoder.L, encoder.W,
                             sd_seas=encoder.sd_seas,
                             sd_res=encoder.sd_res,
                             r2_trend=encoder.r2_trend, encoder=encoder,
                             device=device)
    raise TypeError(f"no index feature adapter for "
                    f"{type(encoder).__name__}; the split tree supports "
                    "SAX, sSAX, tSAX and stSAX")
