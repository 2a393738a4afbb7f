"""PyTorch/CUDA port of the season- and trend-aware symbolic matcher.

Mirrors the JAX package ``repro`` path for path; imports neither JAX
nor that package.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``."""
