"""The port's MSDA against the JAX package's.

``ms_deform_attn_reference`` (plain PyTorch, grid_sample) is held against JAX
``ms_deform_attn`` on both of its routes (slab gathers and the one-hot
matmul) and against the Pallas TPU kernel ``ms_deform_attn_smallv`` run in
interpret mode, which is the kernel the CUDA kernel K1 ports.  Locations span
[-0.1, 1.1] so that zero padding is exercised.  K1 itself is held against
the plain version on the card (tests/test_torch_kernels.py).

The gradients (d_value, d_loc, d_attn) of the port's plain backward
(autograd through the plain version, which kernel K3 + K5 are held against
on the card) are held against ``jax.grad`` through the same three JAX
routes: the slab route's hand-written backward, the autodiff of the one-hot
route and of the Pallas kernel's reference twin.

Tolerance: f32, atol 1e-5.  Each output sums at most 4 * L * P bilinear
terms of unit-scale values; the implementations differ only in rounding
order.  Gradients: atol 1e-5, rtol 1e-4 (d_loc is scaled by the map size).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from unibev_tpu.ops.msda import ms_deform_attn as jax_ms_deform_attn
from unibev_tpu.ops.msda_pallas import ms_deform_attn_smallv

from torch_port_utils import t
from unibev_tpu_torch.ops.msda import (ms_deform_attn_backward,
                                       ms_deform_attn_reference,
                                       msda_fwd_route)

ATOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _inputs(seed, levels, P, B=2, Q=24, heads=4, D=8):
    rng = np.random.RandomState(seed)
    V = sum(h * w for h, w in levels)
    L = len(levels)
    value = rng.randn(B, V, heads, D).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, Q, heads, L, P, 2)).astype(np.float32)
    attn = rng.rand(B, Q, heads, L, P).astype(np.float32)
    attn /= attn.sum(axis=(3, 4), keepdims=True)
    return value, loc, attn


@pytest.mark.parametrize("method", ["slab", "onehot"])
@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("levels", [((7, 9),), ((7, 9), (4, 5))],
                         ids=["L1", "L2"])
def test_reference_matches_jax(levels, P, method):
    value, loc, attn = _inputs(0, levels, P)
    want = np.asarray(jax_ms_deform_attn(jnp.asarray(value), levels,
                                         jnp.asarray(loc), jnp.asarray(attn),
                                         method=method))
    got = ms_deform_attn_reference(t(value), levels, t(loc), t(attn)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["corner", "onehot"])
@pytest.mark.parametrize("P", [4, 8])
def test_reference_matches_pallas_kernel(P, variant):
    """The TPU kernel K1 replaces: one level, heads folded into the batch."""
    H, W = 7, 9
    value, loc, attn = _inputs(1, ((H, W),), P)
    B, Q, heads = loc.shape[:3]
    D = value.shape[-1]
    v_bh = value.transpose(0, 2, 1, 3).reshape(B * heads, H * W, D)
    loc_bh = loc[:, :, :, 0].transpose(0, 2, 1, 3, 4).reshape(B * heads, Q, P, 2)
    attn_bh = attn[:, :, :, 0].transpose(0, 2, 1, 3).reshape(B * heads, Q, P)
    out = ms_deform_attn_smallv(jnp.asarray(v_bh), (H, W), jnp.asarray(loc_bh),
                                jnp.asarray(attn_bh), q_tile=32,
                                interpret=True, variant=variant)
    want = np.asarray(out).reshape(B, heads, Q, D).transpose(0, 2, 1, 3)
    got = ms_deform_attn_reference(t(value), ((H, W),), t(loc), t(attn)).numpy()
    np.testing.assert_allclose(got, want.reshape(B, Q, heads * D), atol=ATOL,
                               rtol=0)


def _grads(fn, value, loc, attn, g):
    """jax.grad of <fn(value, loc, attn), g> -> (d_value, d_loc, d_attn)."""
    return jax.grad(lambda v, l, a: jnp.sum(fn(v, l, a) * g),
                    argnums=(0, 1, 2))(jnp.asarray(value), jnp.asarray(loc),
                                       jnp.asarray(attn))


def _check_grads(got, want):
    for name, a, b in zip(("d_value", "d_loc", "d_attn"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("method", ["slab", "onehot"])
@pytest.mark.parametrize("levels,P", [(((7, 9),), 4), (((7, 9), (4, 5)), 8)],
                         ids=["L1P4", "L2P8"])
def test_backward_matches_jax(levels, P, method):
    value, loc, attn = _inputs(2, levels, P)
    g = np.random.RandomState(3).randn(*loc.shape[:2],
                                       value.shape[2] * value.shape[3])
    g = g.astype(np.float32)
    want = _grads(lambda v, l, a: jax_ms_deform_attn(v, levels, l, a,
                                                     method=method),
                  value, loc, attn, g)
    got = ms_deform_attn_backward(t(value), levels, t(loc), t(attn), t(g))
    _check_grads(got, want)


def test_backward_matches_pallas_kernel():
    """The gradient of the TPU kernel K1 replaces (its backward is autodiff
    of its jnp twin), heads folded into the batch."""
    H, W, P = 7, 9, 8
    value, loc, attn = _inputs(4, ((H, W),), P)
    B, Q, heads = loc.shape[:3]
    D = value.shape[-1]
    g = np.random.RandomState(5).randn(B, Q, heads * D).astype(np.float32)
    v_bh = value.transpose(0, 2, 1, 3).reshape(B * heads, H * W, D)
    loc_bh = loc[:, :, :, 0].transpose(0, 2, 1, 3, 4).reshape(B * heads, Q, P, 2)
    attn_bh = attn[:, :, :, 0].transpose(0, 2, 1, 3).reshape(B * heads, Q, P)
    g_bh = g.reshape(B, Q, heads, D).transpose(0, 2, 1, 3).reshape(B * heads, Q, D)
    dv, dl, da = _grads(lambda v, l, a: ms_deform_attn_smallv(
        v, (H, W), l, a, q_tile=32, interpret=True), v_bh, loc_bh, attn_bh, g_bh)
    want = (np.asarray(dv).reshape(B, heads, H * W, D).transpose(0, 2, 1, 3),
            np.asarray(dl).reshape(B, heads, Q, 1, P, 2).transpose(0, 2, 1, 3, 4, 5),
            np.asarray(da).reshape(B, heads, Q, 1, P).transpose(0, 2, 1, 3, 4))
    got = ms_deform_attn_backward(t(value), ((H, W),), t(loc), t(attn), t(g))
    _check_grads(got, want)


# (D, bytes per element, bytes per access) of an aligned value
K1_WIDTHS = {
    # every MSDA site of the flagship: TSA, camera SCA, decoder, LiDAR TSA
    # and SCA
    "flagship_bf16": (32, 2, 16),
    "flagship_f32": (32, 4, 16),
    # the tiny models: 32 dims over 8 heads, float32
    "tiny_f32": (4, 4, 16),
    "d4_bf16": (4, 2, 8),
    "d6_bf16": (6, 2, 4),
    "d2_bf16": (2, 2, 4),
    "d1_bf16": (1, 2, 2),
    "d3_f32": (3, 4, 4),
}


@pytest.mark.parametrize("case", list(K1_WIDTHS))
def test_k1_route(case):
    """The CUDA kernel K1's access width: 16 bytes wherever a head's row
    allows, else the widest of 8 and 4 bytes that divides it, else one
    element."""
    D, size, width = K1_WIDTHS[case]
    assert msda_fwd_route(D, size) == width
    assert (D * size) % width == 0


@pytest.mark.parametrize("address,vec", [(0, 16), (8, 8), (4, 4), (2, 2),
                                         (6, 2)])
def test_k1_route_narrows_for_unaligned_value(address, vec):
    """value's data pointer narrows the access width too."""
    assert msda_fwd_route(32, 2, address) == vec
