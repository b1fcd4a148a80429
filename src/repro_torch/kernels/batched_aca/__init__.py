"""Batched low-rank apply of ACA factors: CUDA kernel, dispatch, plain version."""
