"""The LM families of the port (``repro.models`` in PyTorch)."""
