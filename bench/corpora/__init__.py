"""Corpus and query generators, one file each, found by the name a
configuration gives."""
