"""Training-side fault tolerance: preemption-aware checkpoint-and-exit
(``repro.runtime.fault_tolerance``).

``StragglerMonitor`` and ``run_with_restarts`` live in ``serve/faults.py``,
as in ``repro``; the training launcher imports them from there.
"""
from __future__ import annotations

import signal


class PreemptionHandler:
    """SIGTERM -> graceful checkpoint-and-exit flag."""

    def __init__(self):
        self.preempted = False
        self._orig = None

    def install(self):
        def handler(signum, frame):
            self.preempted = True
        self._orig = signal.signal(signal.SIGTERM, handler)
        return self

    def uninstall(self):
        if self._orig is not None:
            signal.signal(signal.SIGTERM, self._orig)
            self._orig = None
