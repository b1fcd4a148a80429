"""hlint_torch: device-discipline static analysis for ``src/repro_torch``.

The PyTorch port's twin of ``scripts/hlint`` with its own copy of the
framework (stdlib only: ``ast``, no torch import), its own rules and its own
baseline.  ``python scripts/hlint_torch/run.py --help`` for usage.
"""
