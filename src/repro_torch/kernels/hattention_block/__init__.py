"""H-attention near field (causal leaf blocks) and its backward: CUDA kernels,
dispatch, plain versions."""
