"""build_s: host seconds of ``build_hmatrix(precompute=True)`` (tree, plan
and factors), ended by a synchronize of the card."""


def read(run):
    return run["build_s"]
