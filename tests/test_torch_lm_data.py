"""The port's synthetic LM stream (``repro_torch.data.lm_data``) against
the JAX package's: the same config gives the same unigram table, motifs
and, for every (step, dp_rank, dp_size), the same batch bitwise."""

import numpy as np
import pytest

from repro.data.lm_data import LMDataConfig as RefConfig
from repro.data.lm_data import SyntheticLM as RefLM

from repro_torch.data import LMDataConfig, SyntheticLM

CONFIGS = [dict(vocab_size=256, seq_len=32, global_batch=4),
           dict(vocab_size=151_936, seq_len=64, global_batch=8),
           dict(vocab_size=1000, seq_len=40, global_batch=6, zipf_a=1.05,
                motif_len=8, n_motifs=16, motif_prob=0.5, seed=3)]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: str(kw["vocab_size"]))
def test_tables_bitwise(kw):
    got, want = SyntheticLM(LMDataConfig(**kw)), RefLM(RefConfig(**kw))
    assert got.unigram.dtype == want.unigram.dtype
    np.testing.assert_array_equal(got.unigram, want.unigram)
    assert got.motifs.dtype == want.motifs.dtype
    np.testing.assert_array_equal(got.motifs, want.motifs)


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: str(kw["vocab_size"]))
@pytest.mark.parametrize("step,dp_rank,dp_size", [
    (0, 0, 1), (1, 0, 1), (17, 0, 1), (5, 0, 2), (5, 1, 2), (9, 1, 2)])
def test_batches_bitwise(kw, step, dp_rank, dp_size):
    got = SyntheticLM(LMDataConfig(**kw)).batch(step, dp_rank=dp_rank,
                                                dp_size=dp_size)
    want = RefLM(RefConfig(**kw)).batch(step, dp_rank=dp_rank,
                                        dp_size=dp_size)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        assert got[k].shape == (kw["global_batch"] // dp_size,
                                kw["seq_len"])
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:],
                                  got["labels"][:, :-1])


def test_ranks_split_the_global_batch_differently():
    """Each rank's rows are its own draw: two ranks of one step differ."""
    lm = SyntheticLM(LMDataConfig(vocab_size=256, seq_len=32,
                                  global_batch=4))
    a = lm.batch(3, dp_rank=0, dp_size=2)["tokens"]
    b = lm.batch(3, dp_rank=1, dp_size=2)["tokens"]
    assert not np.array_equal(a, b)
