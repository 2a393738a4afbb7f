"""Season (Large) corpus and query pool, made on the device from a seed.

The paper's Season sets (arXiv:2105.14867, section 4.2): random walks
overlaid with a length-L season mask at a per-series strength drawn
uniformly within ``strength +- spread``, each series z-normalized.  The
construction is that of the port's ``data/synthetic.py::season_dataset(
..., per_series_strength=True)``, rewritten in PyTorch so that it runs
on the card, chunk by chunk, and frozen here.

Every chunk draws from a ``torch.Generator`` of its own, seeded from
(seed, stream, chunk index), so any chunk can be made again alone, on
any device kind, and the corpus and the query pool never share a draw.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STREAMS = {"corpus": 0, "queries": 1}


def chunk_seed(seed: int, stream: str, index: int) -> int:
    """A 63-bit generator seed for one chunk of one stream."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), STREAMS[stream],
                                 int(index)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _znorm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    sd = x.std(-1, keepdim=True, correction=0)
    return (x - mu) / sd.clamp_min(eps)


def make_rows(n: int, spec: dict, seed: int, device) -> torch.Tensor:
    """``n`` series of ``spec`` (T, L, strength, spread) as an (n, T) f32
    tensor on ``device``, from one generator seeded with ``seed``."""
    T, L = int(spec["T"]), int(spec["L"])
    if T % L:
        raise ValueError(f"L={L} must divide T={T}")
    strength, spread = float(spec["strength"]), float(spec["spread"])
    g = torch.Generator(device=device).manual_seed(seed)
    base = _znorm(torch.cumsum(
        torch.randn(n, T, generator=g, device=device), dim=1))
    mask = _znorm(torch.randn(n, L, generator=g, device=device))
    lo, hi = max(0.01, strength - spread), min(0.99, strength + spread)
    s = torch.empty(n, 1, 1, device=device).uniform_(lo, hi, generator=g)
    # remove the walk's own seasonal content so the strength is exact
    periods = base.view(n, T // L, L)
    clean = _znorm((periods - periods.mean(dim=1, keepdim=True))
                   .reshape(n, T)).view(n, T // L, L)
    x = torch.sqrt(s) * mask[:, None, :] + torch.sqrt(1.0 - s) * clean
    return _znorm(x.reshape(n, T))


def n_chunks(spec: dict) -> int:
    return math.ceil(int(spec["n"]) / int(spec["chunk"]))


def corpus_chunk(spec: dict, seed: int, index: int, device) -> torch.Tensor:
    """Chunk ``index`` of the corpus: rows ``index * chunk`` on."""
    chunk = int(spec["chunk"])
    rows = min(chunk, int(spec["n"]) - index * chunk)
    return make_rows(rows, spec, chunk_seed(seed, "corpus", index), device)


def corpus_chunks(spec: dict, seed: int, device):
    """Every chunk of the corpus in row order."""
    for i in range(n_chunks(spec)):
        yield corpus_chunk(spec, seed, i, device)


def query_pool(spec: dict, n: int, seed: int, device) -> torch.Tensor:
    """``n`` held-out series from the query stream."""
    return make_rows(n, spec, chunk_seed(seed, "queries", 0), device)
