"""Serving on the port: the H-matrix servers and LM steps (``step``), the async
panel runtime (``runtime``), multi-tenant serving (``tenancy``) and fault
containment (``faults``)."""
