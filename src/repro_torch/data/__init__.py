"""Deterministic synthetic data pipeline (``pipeline``)."""
