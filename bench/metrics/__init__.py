"""Per-layer metric readers, one file each: ``read(record)`` returns the
metric's value, or None where the traced run held nothing to read (see
``bench.records``)."""
