"""Serving steps of the port: LM prefill and decode (``repro.serve.step``'s LM part)."""
