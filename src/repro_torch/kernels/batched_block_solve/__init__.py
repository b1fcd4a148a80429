"""Batched block Cholesky factorise / solve: CUDA kernels, dispatch, plain versions."""
