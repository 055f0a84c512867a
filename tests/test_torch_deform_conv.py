"""The port's DCNv2 against the JAX package's.

``modulated_deform_conv2d_reference`` (plain PyTorch: one grid_sample per
tap, then a matmul) is held against JAX ``modulated_deform_conv2d`` in f32,
which is its ``_mdcn_clean`` corner-table formulation: two independent
implementations of fractional-offset DCN.  Offsets are fractional and large
enough to push taps out of the map.  The CUDA im2col kernel K2 is held
against the plain version on the card (tests/test_torch_kernels.py).

The gradients (d_x, d_offset, d_mask, d_weight) are held against
``jax.grad`` of ``_mdcn_clean``, the formulation the JAX package's
hand-written backward ``_mdcn_fast_bwd`` differentiates, both through
autograd of the port's op on CPU tensors and through the composition the
card's backward uses: d_cols = g W^T, then the im2col backward (plain
version of kernel K4 + K5) for d_x, d_offset and d_mask.

Tolerance: f32, atol 1e-4.  Each output sums 9 * Cin products of unit-scale
values (up to ~100 in magnitude here); rounding order differs.  Gradients:
atol 1e-5, rtol 1e-4 on values scaled to unit size.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from unibev_tpu.ops.deform_conv import _mdcn_clean
from unibev_tpu.ops.deform_conv import \
    modulated_deform_conv2d as jax_modulated_deform_conv2d

from torch_port_utils import t
from unibev_tpu_torch.ops.deform_conv import (deform_im2col_backward,
                                              modulated_deform_conv2d,
                                              modulated_deform_conv2d_reference)

ATOL = 1e-4
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _inputs(seed, stride, dilation, B=2, H=11, W=13, Cin=6, Cout=5):
    rng = np.random.RandomState(seed)
    pad = dilation
    Ho = (H + 2 * pad - 2 * dilation - 1) // stride + 1
    Wo = (W + 2 * pad - 2 * dilation - 1) // stride + 1
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    offset = (rng.randn(B, Ho, Wo, 18) * 2.5).astype(np.float32)
    mask = rng.rand(B, Ho, Wo, 9).astype(np.float32)
    weight = (rng.randn(9 * Cin, Cout) * 0.2).astype(np.float32)
    bias = rng.randn(Cout).astype(np.float32)
    return x, offset, mask, weight, bias


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
def test_reference_matches_jax(stride, dilation):
    x, offset, mask, weight, bias = _inputs(0, stride, dilation)
    assert (np.abs(offset) > 3).any()          # some taps land off the map
    kw = dict(stride=stride, padding=dilation, dilation=dilation)
    want = np.asarray(jax_modulated_deform_conv2d(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(mask),
        jnp.asarray(weight), jnp.asarray(bias), **kw))
    got = modulated_deform_conv2d_reference(
        t(x), t(offset), t(mask), t(weight), t(bias), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_integer_offsets_are_a_shifted_conv():
    """With every tap moved by whole pixels the DCN is a plain conv of the
    shifted input: an oracle independent of both implementations."""
    x, offset, mask, weight, _ = _inputs(1, 1, 1)
    B, H, W, Cin = x.shape
    offset = np.zeros_like(offset)
    offset[..., 0::2] = 1.0                    # dy = +1 for every tap
    mask = np.ones_like(mask)
    got = modulated_deform_conv2d_reference(t(x), t(offset), t(mask),
                                            t(weight)).numpy()
    shifted = np.concatenate([x[:, 1:], np.zeros_like(x[:, :1])], axis=1)
    w = torch.from_numpy(weight.reshape(3, 3, Cin, -1).transpose(3, 2, 0, 1).copy())
    want = torch.nn.functional.conv2d(
        torch.from_numpy(shifted.transpose(0, 3, 1, 2).copy()), w, padding=1)
    # row 0 differs by construction: the DCN reads x[0] where the shifted
    # conv reads its zero padding
    np.testing.assert_allclose(got[:, 1:], want.numpy().transpose(0, 2, 3, 1)[:, 1:],
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_backward_matches_jax(stride, dilation):
    x, offset, mask, weight, _ = _inputs(2, stride, dilation)
    kw = dict(stride=stride, padding=dilation, dilation=dilation)
    g = np.random.RandomState(3).randn(*offset.shape[:3], weight.shape[1])
    g = (g / np.sqrt(g.size)).astype(np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(_mdcn_clean(*a, (3, 3), stride, dilation, dilation)
                           * g), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, offset, mask, weight)))
    want = [np.asarray(w) for w in want]
    names = ("d_x", "d_offset", "d_mask", "d_weight")

    inputs = [t(a).requires_grad_() for a in (x, offset, mask, weight)]
    out = modulated_deform_conv2d(*inputs, **kw)
    got = torch.autograd.grad(out, inputs, t(g))
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **GRAD_TOL)

    d_cols = t(g).reshape(-1, weight.shape[1]) @ t(weight).T
    got = deform_im2col_backward(t(x), t(offset), t(mask), d_cols, **kw)
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **GRAD_TOL)
