"""The decoder-only LM of the port (``repro.models`` in PyTorch; dense blocks)."""
