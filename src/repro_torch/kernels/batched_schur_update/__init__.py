"""Batched Schur updates of H-LU (dense targets: CUDA kernel; low-rank
targets: the recompression kernel at the widened width), dispatch, plain
versions."""
