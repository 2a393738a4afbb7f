"""Store helpers the engine needs before ``SymbolicStore`` is ported."""

from __future__ import annotations

from typing import Optional


def epoch_rows(epoch) -> Optional[int]:
    """Resolve an epoch argument (an object with ``n_rows`` | int | None)
    to the visible row count, or None for "live" — the one coercion every
    layer that accepts ``epoch=`` shares."""
    if epoch is None:
        return None
    return int(getattr(epoch, "n_rows", epoch))
