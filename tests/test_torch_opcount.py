"""The port's operation counter (``repro_torch.analysis.opcount``) against
``repro.analysis.hlo.analyze_hlo`` on the compiled text of the same
functions (``tests/test_hlo_analysis.py``): a product, a 5-step scan of
products against a 5-step Python loop, a nested 3 x 4 loop.  The port's
functions run on fake tensors."""
import jax
import jax.numpy as jnp
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis.hlo import analyze_hlo
from repro_torch.analysis.opcount import ModuleStats, OpCounter, count_ops
from torch_parity_util import one_torch_thread  # noqa: F401


def _hlo(fn, *args):
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())


def test_simple_product():
    want = _hlo(lambda a, b: a @ b, jnp.zeros((64, 128), jnp.float32),
                jnp.zeros((128, 32), jnp.float32))
    with FakeTensorMode():
        a, b = torch.zeros(64, 128), torch.zeros(128, 32)
        got = count_ops(lambda: a @ b)
    assert got.dot_flops == want.dot_flops == 2 * 64 * 128 * 32
    assert got.traffic_bytes == (64 * 128 + 128 * 32 + 64 * 32) * 4 > 0
    assert got.collective_bytes is None and isinstance(got, ModuleStats)


def test_scan_of_products_against_a_python_loop():
    def f(w, x):
        def body(x, wi):
            return jnp.tanh(x @ wi), None
        return jax.lax.scan(body, x, w)[0]

    want = _hlo(f, jnp.zeros((5, 32, 32), jnp.float32), jnp.zeros((8, 32), jnp.float32))
    with FakeTensorMode():
        w, x = torch.zeros(5, 32, 32), torch.zeros(8, 32)

        def g():
            y = x
            for i in range(5):
                y = torch.tanh(y @ w[i])
            return y
        got = count_ops(g)
    assert got.dot_flops == want.dot_flops == 5 * 2 * 8 * 32 * 32
    # 5 products (operands and result) and 5 tanh results; w[i] is a view
    assert got.traffic_bytes == 5 * ((8 * 32 + 32 * 32 + 8 * 32) + 8 * 32) * 4


def test_nested_loops_compound():
    def f(w, x):
        def outer(x, wo):
            def inner(x, wi):
                return x @ wi, None
            return jax.lax.scan(inner, x, wo)[0], None
        return jax.lax.scan(outer, x, w)[0]

    want = _hlo(f, jnp.zeros((3, 4, 16, 16), jnp.float32), jnp.zeros((2, 16), jnp.float32))
    with FakeTensorMode():
        w, x = torch.zeros(3, 4, 16, 16), torch.zeros(2, 16)
        with OpCounter() as counter:
            y = x
            for i in range(3):
                for j in range(4):
                    y = y @ w[i, j]
    assert counter.stats.dot_flops == want.dot_flops == 3 * 4 * 2 * 2 * 16 * 16


def test_inference_mode_and_einsum_count_their_products():
    with FakeTensorMode():
        a, b = torch.zeros(4, 8, 16, dtype=torch.bfloat16), torch.zeros(16, 32,
                                                                         dtype=torch.bfloat16)
        with torch.inference_mode():
            got = count_ops(lambda: torch.einsum("bsd,de->bse", a, b))
            lin = count_ops(lambda: torch.nn.functional.linear(a, b.T))
    assert got.dot_flops == lin.dot_flops == 2 * 4 * 8 * 16 * 32
    assert got.traffic_bytes > 0
