"""Synthetic datasets per the paper's §4.2 (numpy only).

Season / Trend datasets: random-walk base overlaid with a deterministic
component, rescaled so every series hits the target component strength
R^2 within +-0.5pp, then z-normalized.  Construction note: for a target
strength on a *normalized* series it suffices to mix the normalized
deterministic component and the normalized walk with weights sqrt(R^2) /
sqrt(1-R^2) — the extraction estimators then recover R^2 up to estimation
noise, matching the paper's tolerance-based selection.  Same seed, same
arrays as the JAX package's generators.
"""

from __future__ import annotations

import numpy as np


def random_walk(rng: np.random.Generator, n: int, T: int) -> np.ndarray:
    steps = rng.normal(size=(n, T)).astype(np.float32)
    return np.cumsum(steps, axis=1)


def _znorm_np(x, eps=1e-12):
    mu = x.mean(axis=-1, keepdims=True)
    sd = x.std(axis=-1, keepdims=True)
    return (x - mu) / np.maximum(sd, eps)


def season_dataset(n: int = 1000, T: int = 960, L: int = 10,
                   strength: float = 0.5, seed: int = 0,
                   per_series_strength: bool = False) -> np.ndarray:
    """Random walks overlaid with a length-L season mask (paper: L=10).

    ``per_series_strength`` draws each series' strength uniformly around
    the target (the Season (Large) construction where strengths vary).
    """
    rng = np.random.default_rng(seed)
    if T % L:
        raise ValueError(f"L={L} must divide T={T}")
    base = _znorm_np(random_walk(rng, n, T))
    # one season mask per series, zero-mean, tiled over the length
    mask = rng.normal(size=(n, L)).astype(np.float32)
    mask = mask - mask.mean(axis=1, keepdims=True)
    mask = mask / np.maximum(mask.std(axis=1, keepdims=True), 1e-12)
    seas = np.tile(mask, (1, T // L))
    if per_series_strength:
        s = rng.uniform(max(0.01, strength - 0.09),
                        min(0.99, strength + 0.09), size=(n, 1)).astype(
                            np.float32)
    else:
        s = np.full((n, 1), strength, np.float32)
    # remove the walk's own seasonal content so the target strength is exact
    walk_seas = np.tile(
        base.reshape(n, T // L, L).mean(axis=1), (1, T // L))
    base_clean = _znorm_np(base - walk_seas)
    x = np.sqrt(s) * seas + np.sqrt(1.0 - s) * base_clean
    return _znorm_np(x)


def trend_dataset(n: int = 1000, T: int = 960, strength: float = 0.5,
                  seed: int = 0) -> np.ndarray:
    """Random walks overlaid with a linear trend of target strength."""
    rng = np.random.default_rng(seed)
    base = _znorm_np(random_walk(rng, n, T))
    # detrend the walk so the injected trend fully controls R^2_tr
    s_ax = np.arange(T, dtype=np.float32)
    s_c = s_ax - s_ax.mean()
    den = np.sum(s_c * s_c)
    beta = (base @ s_c) / den
    base_dt = _znorm_np(base - beta[:, None] * s_c[None, :])
    tr = _znorm_np(np.tile(s_c[None, :], (n, 1)))
    sign = rng.choice(np.asarray([-1.0, 1.0], np.float32), size=(n, 1))
    s = np.full((n, 1), strength, np.float32)
    x = np.sqrt(s) * sign * tr + np.sqrt(1.0 - s) * base_dt
    return _znorm_np(x)


def season_corpus(n: int, T: int = 960, L: int = 10, strength: float = 0.5,
                  seed: int = 0, per_series_strength: bool = False,
                  chunk: int = 65536) -> np.ndarray:
    """``season_dataset`` of ``n`` rows built chunk by chunk into one
    (n, T) f32 array, so a million-row corpus holds only a few chunks'
    temporaries at once.  Chunk ``i`` is ``season_dataset(..., seed=seed
    + i)``; with ``n <= chunk`` the result IS ``season_dataset(n, ...,
    seed=seed)``.  Chunks are generated on up to 8 threads (numpy
    releases the GIL in its bulk kernels)."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    out = np.empty((n, T), np.float32)

    def fill(i):
        lo = i * chunk
        hi = min(n, lo + chunk)
        out[lo:hi] = season_dataset(hi - lo, T, L, strength, seed=seed + i,
                                    per_series_strength=per_series_strength)

    n_chunks = -(-n // chunk)
    workers = max(1, min(8, os.cpu_count() or 1, n_chunks))
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(fill, range(n_chunks)))
    return out
