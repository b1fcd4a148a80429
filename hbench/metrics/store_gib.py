"""store_gib: GiB of the stored ACA factors (``HMatrix.memory_report()``'s
``factor_bytes``, counted by the program)."""


def read(run):
    return run["store_bytes"] / float(1 << 30)
