"""The port's row scatter-add against the JAX package's.

``scatter_add_rows_reference`` (a float32 ``index_add_``, the plain version
of kernel K5) is held against the Pallas TPU kernel it ports,
``unibev_tpu/ops/scatter_pallas.py::scatter_add_rows``, run in interpret
mode, and against XLA's ``.at[idx].add``.  K5 itself is held against the
plain version on the card (tests/test_torch_kernels.py).

Tolerances: f32 exactly (both add the rows in index order in f32).  bf16:
the Pallas kernel rounds to bf16 after every add, the port sums in f32 and
rounds once.  So the port is held within one bf16 step (at each sum's own
magnitude) of the exact float64 sum, and its largest error must not exceed
the Pallas kernel's: at least as accurate.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from unibev_tpu.ops.scatter_pallas import scatter_add_rows as pallas_scatter

from torch_port_utils import t
from unibev_tpu_torch.ops.scatter import (scatter_add_rows,
                                          scatter_add_rows_reference)


def _inputs(seed, M=256, L=128, tr=64):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, tr, M).astype(np.int32)
    contrib = rng.randn(M, L).astype(np.float32)
    contrib[-32:] = 0.0          # padded entries carry zero contributions
    return idx, contrib, tr


def _bf16_step(x):
    """The spacing of bf16 numbers at |x|, elementwise."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -100))) - 7)


def _check_against(want, idx, contrib, tr, dtype):
    """f32: exactly; bf16: within one step of the exact sum and no worse than
    ``want`` (a bf16-accumulated table)."""
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    got = scatter_add_rows(t(idx), t(contrib).to(tdt), tr)
    assert got.dtype == torch.float32 and got.shape == (tr, 128)
    got = got.to(tdt).float().numpy()
    if dtype == "f32":
        np.testing.assert_array_equal(got, want)
        return
    rounded = t(contrib).bfloat16().double().numpy()
    exact = np.zeros((tr, 128))
    np.add.at(exact, idx, rounded)
    assert (np.abs(got - exact) <= _bf16_step(exact)).all()
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_version_matches_pallas_kernel(dtype):
    idx, contrib, tr = _inputs(0)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        want = pallas_scatter(jnp.asarray(idx), jnp.asarray(contrib, jdt), tr,
                              mc=64)
    _check_against(np.asarray(want.astype(jnp.float32)), idx, contrib, tr, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_version_matches_xla_scatter(dtype):
    idx, contrib, tr = _inputs(1)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    want = jnp.zeros((tr, 128), jdt).at[idx].add(jnp.asarray(contrib, jdt))
    _check_against(np.asarray(want.astype(jnp.float32)), idx, contrib, tr, dtype)


def test_chunks_accumulate_into_one_table():
    idx, contrib, tr = _inputs(2)
    table = scatter_add_rows(t(idx[:100]), t(contrib[:100]), tr)
    table = scatter_add_rows(t(idx[100:]), t(contrib[100:]), tr, out=table)
    np.testing.assert_allclose(
        table.numpy(), scatter_add_rows_reference(t(idx), t(contrib), tr).numpy(),
        atol=1e-5, rtol=0)
