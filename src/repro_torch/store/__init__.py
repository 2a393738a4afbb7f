"""Streaming symbolic store: append-only raw + representation ownership
with incremental encoding, published epochs and atomic on-disk
snapshots in the JAX package's format."""

from repro_torch.store.symbolic import (  # noqa: F401
    MEDIA, CorpusEpoch, SymbolicStore, epoch_rows, rep_leaves)
from repro_torch.store.snapshot import (  # noqa: F401
    latest_snap, open_store, save_store)
