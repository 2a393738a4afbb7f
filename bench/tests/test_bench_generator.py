"""The frozen corpus and query generator: the same seed gives the same
rows, chunk by chunk, and the rows are the Season construction's."""

import numpy as np
import torch

from bench.corpora import season

SPEC = {"n": 700, "T": 960, "L": 10, "strength": 0.5, "spread": 0.09,
        "chunk": 256}


def _corpus(seed):
    return torch.cat(list(season.corpus_chunks(SPEC, seed, "cpu")))


def test_same_seed_same_rows_and_large_seeds():
    seed = 2 ** 31 + 12345
    a, b = _corpus(seed), _corpus(seed)
    assert a.shape == (700, 960) and torch.equal(a, b)
    assert not torch.equal(a, _corpus(seed + 1))
    assert season.n_chunks(SPEC) == 3
    # a chunk made alone is the same chunk
    assert torch.equal(season.corpus_chunk(SPEC, seed, 2, "cpu"), a[512:])


def test_queries_are_a_stream_of_their_own():
    seed = 7
    q = season.query_pool(SPEC, 64, seed, "cpu")
    assert torch.equal(q, season.query_pool(SPEC, 64, seed, "cpu"))
    c = _corpus(seed)
    assert not (q[:, None, :] == c[None, :, :]).all(-1).any()


def test_rows_are_znormalized_with_the_season_strength():
    x = _corpus(3).double()
    assert torch.allclose(x.mean(1), torch.zeros(700, dtype=x.dtype),
                          atol=1e-5)
    assert torch.allclose(x.std(1, correction=0),
                          torch.ones(700, dtype=x.dtype), atol=1e-4)
    # the season's share of the variance: the per-phase means' variance
    per = x.view(700, 96, 10).mean(1)
    r2 = per.var(1, correction=0).numpy()
    assert 0.38 < np.median(r2) < 0.62
    assert r2.min() > 0.3 and r2.max() < 0.7


def test_chunk_seeds_differ_by_stream_and_index():
    seeds = {season.chunk_seed(5, s, i) for s in season.STREAMS
             for i in range(4)}
    assert len(seeds) == 8 and all(0 <= s < 2 ** 63 for s in seeds)
