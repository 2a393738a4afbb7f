"""Store layer; only ``epoch_rows`` is ported so far."""
