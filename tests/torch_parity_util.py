"""Helpers of the port-parity tests (``tests/test_torch_*.py``).

``export_hmatrix`` turns a ``repro`` (JAX) HMatrix into the NumPy arrays
that ``repro_torch.convert.hmatrix_from_arrays`` takes, so both packages
apply the same tree, plan and factors.  ``randomise`` gives an LM parameter
tree's constant-initialised leaves seeded random values.
``one_torch_thread`` is the autouse fixture every ``tests/test_torch_*.py``
imports (a fixture imported into a test module is active there).
``jax_mesh`` makes a ``jax.sharding.AbstractMesh`` ``repro``'s active mesh.
"""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: beside XLA's own pool in the same process, more
    threads only contend (and the suite runs several workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# leaf name -> how a seeded random value replaces repro's constant initialisation
_RANDOMISED = {
    "bq": lambda r, x: 0.1 * r.randn(*x.shape), "bk": lambda r, x: 0.1 * r.randn(*x.shape),
    "bv": lambda r, x: 0.1 * r.randn(*x.shape), "w": lambda r, x: 0.1 * r.randn(*x.shape),
    "b": lambda r, x: 0.1 * r.randn(*x.shape), "bias": lambda r, x: 0.1 * r.randn(*x.shape),
    "a_log": lambda r, x: 0.5 * r.randn(*x.shape), "dt_bias": lambda r, x: 0.5 * r.randn(*x.shape),
    "d_skip": lambda r, x: 1.0 + 0.1 * r.randn(*x.shape),
    "f_bias": lambda r, x: 3.0 + 0.5 * r.randn(*x.shape),
}


def randomise(tree, rng):
    """``repro``'s constant-initialised leaves (biases, norm gains, the SSM
    and xLSTM constants) of an LM parameter tree -> seeded random values."""
    import jax
    import jax.numpy as jnp

    def leaf(path, x):
        fn = _RANDOMISED.get(getattr(path[-1], "key", None))
        return x if fn is None else jnp.asarray(fn(rng, x).astype(np.float32))
    return jax.tree_util.tree_map_with_path(leaf, tree)


class jax_mesh:
    """``repro``'s active mesh for the block: an ``AbstractMesh`` of
    ``sizes`` over ``names``, set through ``repro.parallel.mesh_ctx._state``
    (``repro``'s ``use_mesh`` enters the mesh, which an abstract mesh does not
    support) and restored in a finally.  No forced host devices."""

    def __init__(self, sizes, names):
        from jax.sharding import AbstractMesh
        self.mesh = AbstractMesh(tuple(sizes), tuple(names))

    def __enter__(self):
        from repro.parallel import mesh_ctx
        self.prev = getattr(mesh_ctx._state, "mesh", None)
        mesh_ctx._state.mesh = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        from repro.parallel import mesh_ctx
        mesh_ctx._state.mesh = self.prev
