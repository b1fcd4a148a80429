"""The plain reference the benchmark judges the port against (plain
PyTorch; imports nothing of the program and nothing of JAX)."""
