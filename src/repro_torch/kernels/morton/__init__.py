"""Morton (Z-order) encode of the device build: CUDA kernel, dispatch, plain version."""
