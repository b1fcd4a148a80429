"""Architecture and shape configs of the port (copies of ``repro.configs``)."""
