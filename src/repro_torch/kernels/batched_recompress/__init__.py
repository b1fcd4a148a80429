"""Batched algebraic recompression of ACA factors: CUDA kernel, dispatch,
plain version."""
