"""Synthetic datasets, the real-world surrogates and the synthetic LM
token stream (numpy only)."""

from repro_torch.data.synthetic import (  # noqa: F401
    random_walk, season_dataset, trend_dataset)
from repro_torch.data.datasets import (  # noqa: F401
    metering_like, economy_like)
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM  # noqa: F401
