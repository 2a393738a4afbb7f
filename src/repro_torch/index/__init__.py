"""Candidate sources; only the linear sweep is ported so far."""
