"""Analysis tooling of the port: analytic FLOPs (``flops``)."""
