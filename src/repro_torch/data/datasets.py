"""Real-world dataset surrogates (numpy only).

The CER Metering and M4 Economy datasets are not redistributable; these
functions produce statistically matched stand-ins:

* ``metering_like`` — half-hourly consumption series with a daily season
  (L=48) of mean strength 18.3% (the paper's measured figure), weekly
  modulation, and positive-valued load shapes.
* ``economy_like`` — monthly series (T=300: 25 years) with pronounced
  trends of heterogeneous strength, multiplicative noise, and mild yearly
  seasonality — mimicking M4-monthly's trend-dominated behaviour.
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import _znorm_np, random_walk


def metering_like(n: int = 1024, days: int = 65, seed: int = 1):
    """(n, days*48) z-normalized consumption-like series."""
    rng = np.random.default_rng(seed)
    T = days * 48
    t = np.arange(T, dtype=np.float32)
    # daily load shape: morning/evening peaks, per-household phase
    phase = rng.uniform(0, 2 * np.pi, size=(n, 1)).astype(np.float32)
    daily = (np.sin(2 * np.pi * t / 48 + phase)
             + 0.6 * np.sin(4 * np.pi * t / 48 + 1.7 * phase))
    weekly = 0.3 * np.sin(2 * np.pi * t / (48 * 7)
                          + rng.uniform(0, 2 * np.pi, (n, 1)))
    noise = _znorm_np(random_walk(rng, n, T))
    # strengths drawn so the dataset mean R^2(daily) is ~0.183
    s = np.clip(rng.beta(2.0, 8.5, size=(n, 1)).astype(np.float32), 0.01, 0.9)
    x = (np.sqrt(s) * _znorm_np(daily + weekly)
         + np.sqrt(1 - s) * noise)
    return _znorm_np(x)


def economy_like(n: int = 1024, T: int = 300, seed: int = 2):
    """(n, 300) z-normalized monthly economic-like series with trends."""
    rng = np.random.default_rng(seed)
    t = np.arange(T, dtype=np.float32)
    tc = (t - t.mean()) / t.std()
    slope = rng.normal(0.0, 1.0, size=(n, 1)).astype(np.float32)
    curv = rng.normal(0.0, 0.3, size=(n, 1)).astype(np.float32)
    trend = slope * tc + curv * (tc ** 2 - 1.0)
    yearly = 0.25 * np.sin(2 * np.pi * t / 12
                           + rng.uniform(0, 2 * np.pi, (n, 1)))
    noise = _znorm_np(random_walk(rng, n, T))
    s = np.clip(rng.beta(5.0, 2.0, size=(n, 1)).astype(np.float32),
                0.05, 0.98)
    x = (np.sqrt(s) * _znorm_np(trend + yearly)
         + np.sqrt(1 - s) * noise)
    return _znorm_np(x)
