"""Synthetic datasets and the real-world surrogates (numpy only)."""

from repro_torch.data.synthetic import (  # noqa: F401
    random_walk, season_dataset, trend_dataset)
from repro_torch.data.datasets import (  # noqa: F401
    metering_like, economy_like)
