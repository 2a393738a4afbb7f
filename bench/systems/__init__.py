"""Systems under test, one file each: how a configuration builds the
program it measures."""
