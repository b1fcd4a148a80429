"""Batched ACA (factors) and low-rank apply of ACA factors: CUDA kernels,
dispatch, plain versions."""
