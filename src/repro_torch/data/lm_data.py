"""Synthetic LM token pipeline: deterministic, step-indexed, shardable.

Batches are a pure function of (step, dp_rank) — the property the
fault-tolerant loop relies on for idempotent replay after restart, and
the elastic restore relies on for re-splitting across a new dp degree.
The stream is a mixture of Zipfian unigrams and a repeated-motif process,
so small models show a real learning curve (loss drops well below the
uniform-entropy floor).  Pure numpy: a copy of the JAX package's module,
so every (step, dp_rank, dp_size) gives the same batch bitwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    zipf_a: float = 1.2
    motif_len: int = 16
    n_motifs: int = 64
    motif_prob: float = 0.7
    seed: int = 17


class SyntheticLM:
    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self.unigram = (p / p.sum()).astype(np.float64)
        self.motifs = rng.integers(
            0, V, size=(cfg.n_motifs, cfg.motif_len)).astype(np.int32)

    def batch(self, step: int, *, dp_rank: int = 0, dp_size: int = 1):
        """dict(tokens, labels) for this step/rank; labels = next token."""
        cfg = self.cfg
        assert cfg.global_batch % dp_size == 0
        b_local = cfg.global_batch // dp_size
        rng = np.random.default_rng(
            (cfg.seed, step, dp_rank))
        S = cfg.seq_len + 1
        toks = rng.choice(cfg.vocab_size, size=(b_local, S),
                          p=self.unigram).astype(np.int32)
        # overlay motifs: predictable spans the model can learn
        n_spans = int(cfg.motif_prob * S / cfg.motif_len)
        for i in range(b_local):
            starts = rng.integers(0, S - cfg.motif_len, size=n_spans)
            ids = rng.integers(0, cfg.n_motifs, size=n_spans)
            for s, m in zip(starts, ids):
                toks[i, s:s + cfg.motif_len] = self.motifs[m]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
