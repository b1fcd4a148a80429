"""Batched panel triangular solve (H-LU's TRSM task): CUDA kernel, dispatch,
plain version."""
