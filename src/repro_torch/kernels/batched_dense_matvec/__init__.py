"""Batched dense kernel-block product: CUDA kernel, dispatch, plain version."""
