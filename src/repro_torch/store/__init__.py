"""Streaming symbolic store: append-only raw + representation ownership
with incremental encoding and published epochs.  Snapshots are not
ported yet."""

from repro_torch.store.symbolic import (  # noqa: F401
    MEDIA, CorpusEpoch, SymbolicStore, epoch_rows, rep_leaves)
