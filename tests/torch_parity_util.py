"""Helpers of the port-parity tests (``tests/test_torch_*.py``).

``export_hmatrix`` turns a ``repro`` (JAX) HMatrix into the NumPy arrays
that ``repro_torch.convert.hmatrix_from_arrays`` takes, so both packages
apply the same tree, plan and factors.
"""
import numpy as np


def export_hmatrix(hm) -> dict:
    tree, plan = hm.tree, hm.plan
    arrays = {"points": tree.points, "perm": tree.perm, "n": tree.n, "n_pad": tree.n_pad,
              "c_leaf": tree.c_leaf, "n_levels": tree.n_levels, "eta": plan.eta,
              "k": hm.k, "kernel_name": hm.kernel_name, "dense_blocks": plan.dense_blocks}
    for lv in range(tree.n_levels + 1):
        arrays[f"bb_min/{lv}"] = tree.bb_min[lv]
        arrays[f"bb_max/{lv}"] = tree.bb_max[lv]
    for lv, blocks in plan.aca_levels.items():
        arrays[f"aca_levels/{lv}"] = blocks
    if hm.factors is not None:
        for lv, (u, v) in hm.factors.items():
            arrays[f"U/{lv}"] = u
            arrays[f"V/{lv}"] = v
    return {key: np.asarray(val) for key, val in arrays.items()}


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))
