"""Analysis tooling of the port: analytic FLOPs (``flops``), the H100
roofline (``roofline``) and operation counts of a fake-tensor run
(``opcount``, the twin of ``repro.analysis.hlo``)."""
