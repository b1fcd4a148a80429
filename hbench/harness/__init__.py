"""The benchmark's own machinery: cell resolution, inputs, traffic, the
window's driver, the trace reduction, the work functions and the judge.

Nothing here imports the JAX package or JAX.  The port, ``repro_torch``, is
reached only through its public entry points, from ``hbench/run.py``.
"""
