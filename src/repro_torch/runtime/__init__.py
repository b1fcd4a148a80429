"""Training runtime: checkpoints (``checkpoint``) and preemption (``fault_tolerance``)."""
