"""H-attention near field (causal leaf blocks): CUDA kernel, dispatch, plain version."""
