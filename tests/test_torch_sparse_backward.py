"""The sparse conv's backward: the port's inverse rulebook, weight gradient
and ``SparseConvFn`` against the JAX package's custom VJPs.

* ``sparse_inv_nbr_reference`` (the plain version of K8) equals
  ``inverse_strided_idx`` for every strided kernel the middle encoder runs
  (k3 s2 with padding 1 and (0, 1, 1), and (3, 1, 1) s(2, 1, 1)), with a
  capacity above and below the output site count: a dropped site must read
  the sentinel; and it is the transpose of the forward rulebook;
* ``sparse_conv_wgrad_reference`` (the plain version of K9) equals
  ``_dw_dot`` on the gathered columns, f32 and bf16 inputs;
* ``sparse_conv``'s gradients (d_feats, d_weight) equal ``jax.vjp`` of
  ``subm_gather_conv`` and of ``strided_xpair_conv(plan=None, inv_idx=...)``
  on the same cotangent, and torch autograd through the plain forward
  ``sparse_conv_reference``, an independent oracle;
* the backward that runs is ``SparseConvFn``'s, not plain autograd.

Index tables are compared exactly; gradients atol 1e-5 / rtol 1e-4 (f32,
the same products summed in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from unibev_tpu.ops import sparse_conv as jsc

from test_sparse_conv import make_sparse
from torch_port_utils import t
from unibev_tpu_torch.ops import sparse_conv as sc
from unibev_tpu_torch.ops.sparse_conv import (SparseGrid, build_table,
                                              downsample_with_table,
                                              sparse_conv,
                                              sparse_conv_reference,
                                              sparse_conv_wgrad_reference,
                                              sparse_inv_nbr_reference,
                                              strided_neighbor_idx,
                                              subm_neighbor_idx)

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
B, D, H, W, CIN, COUT = 2, 9, 12, 11, 6, 7
STRIDED = [((3, 3, 3), (2, 2, 2), (1, 1, 1)),
           ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
           ((3, 1, 1), (2, 1, 1), (0, 0, 0))]
IDS = ["k3s2p1", "k3s2p011", "conv_out"]
SATURATED = 60     # below the output sites of every strided kernel here


@pytest.fixture(scope="module")
def sparse():
    """An active set of 300 of the 2376 cells in 400 shuffled rows, as
    numpy, JAX and port grids with their tables."""
    rng = np.random.RandomState(0)
    feats, coords, mask = make_sparse(rng, B, D, H, W, CIN, 300, 400)
    perm = rng.permutation(400)
    feats, coords, mask = feats[perm], coords[perm], mask[perm]
    jgrid = jsc.SparseGrid(jnp.asarray(coords), jnp.asarray(mask), (D, H, W), B)
    grid = SparseGrid(torch.from_numpy(coords), torch.from_numpy(mask),
                      (D, H, W), B)
    return dict(feats=feats, coords=coords, mask=mask, jgrid=jgrid,
                jtable=jsc.build_table(jgrid), grid=grid, table=build_table(grid))


def _out_shape(kernel, stride, padding):
    return tuple((s + 2 * p - k) // st + 1 for s, p, k, st in
                 zip((D, H, W), padding, kernel, stride))


def _strided(sparse, kernel, stride, padding, cap):
    """Both packages' (output mask, rulebook, inverse rulebook) of one
    strided conv: (port tensors, JAX arrays)."""
    out_shape = _out_shape(kernel, stride, padding)
    co, mo, tab, _ = downsample_with_table(sparse["grid"], sparse["table"],
                                           kernel, stride, padding, out_shape,
                                           cap)
    sidx = strided_neighbor_idx(sparse["grid"], sparse["table"], co, mo,
                                kernel, stride, padding)
    inv = sparse_inv_nbr_reference(tab, cap, out_shape, sparse["grid"].coords,
                                   sparse["grid"].mask, kernel, stride, padding)
    jco, jmo, jtab, _ = jsc.downsample_with_table(
        jnp.asarray(sparse["coords"]), jnp.asarray(sparse["mask"]), kernel,
        stride, padding, out_shape, cap, B, in_shape=(D, H, W),
        table_in=sparse["jtable"])
    jsidx = jsc.strided_neighbor_idx(sparse["jgrid"], sparse["jtable"], jco,
                                     jmo, kernel, stride, padding)
    jinv = jsc.inverse_strided_idx(jnp.asarray(sparse["coords"]),
                                   jnp.asarray(sparse["mask"]), jtab, kernel,
                                   stride, padding, out_shape, cap)
    return (mo, sidx, inv), (jmo, jsidx, jinv)


@pytest.mark.parametrize("cap", [1000, SATURATED], ids=["roomy", "saturated"])
@pytest.mark.parametrize("kernel,stride,padding", STRIDED, ids=IDS)
def test_inverse_rulebook_matches_jax(sparse, kernel, stride, padding, cap):
    (mo, _, inv), (_, _, jinv) = _strided(sparse, kernel, stride, padding, cap)
    assert inv.dtype == torch.int32
    assert inv.shape == (400, kernel[0] * kernel[1] * kernel[2])
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    assert bool((inv < cap).any()) and bool((inv == cap).any())
    assert bool((inv[~sparse["grid"].mask] == cap).all())
    if cap == SATURATED:
        # the capacity dropped sites: their inputs read the sentinel there
        assert int(mo.sum()) == cap
        roomy = _strided(sparse, kernel, stride, padding, 1000)[0][2]
        assert int((inv < cap).sum()) < int((roomy < 1000).sum())


@pytest.mark.parametrize("kernel,stride,padding", STRIDED, ids=IDS)
def test_inverse_rulebook_is_the_transposed_rulebook(sparse, kernel, stride,
                                                     padding):
    """inv[i, k] == o  iff  nidx[o, k] == i, for live i and o."""
    (_, sidx, inv), _ = _strided(sparse, kernel, stride, padding, SATURATED)
    o, k = (sidx < 400).nonzero(as_tuple=True)
    i = sidx[o, k].long()
    assert torch.equal(inv[i, k].long(), o)
    assert int((inv < SATURATED).sum()) == o.numel()


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_wgrad_reference_matches_jax_dw_dot(sparse, dtype):
    rng = np.random.RandomState(1)
    nidx = subm_neighbor_idx(sparse["grid"], sparse["table"])
    g = rng.randn(400, COUT).astype(np.float32)
    feats = jnp.asarray(sparse["feats"]).astype(dtype)
    jg = jnp.asarray(g).astype(dtype)
    pad = jnp.concatenate([feats, jnp.zeros((1, CIN), feats.dtype)])
    cols = jnp.take(pad, jnp.asarray(nidx.numpy()).reshape(-1), axis=0).reshape(
        400, 27 * CIN)
    want = np.asarray(jsc._dw_dot(cols, jg))
    tdtype = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = sparse_conv_wgrad_reference(t(feats.astype(jnp.float32)).to(tdtype),
                                      nidx, t(jg.astype(jnp.float32)).to(tdtype))
    assert got.dtype == torch.float32 and got.shape == (27 * CIN, COUT)
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


def _vjp_cases(sparse, case):
    """(port rulebook, output mask, inverse rulebook or None) and the JAX
    conv as a function of (feats, weight), for one case."""
    if case == "subm":
        nidx = subm_neighbor_idx(sparse["grid"], sparse["table"])
        jnidx = jsc.subm_neighbor_idx(sparse["jgrid"], sparse["jtable"])
        jmask = jnp.asarray(sparse["mask"])
        port = (nidx, sparse["grid"].mask, None)
        return port, lambda f, w: jsc.subm_gather_conv(f, jnidx, w, jmask)
    kernel, stride, padding = STRIDED[IDS.index(case)]
    (mo, sidx, inv), (jmo, jsidx, jinv) = _strided(sparse, kernel, stride,
                                                   padding, SATURATED)
    return (sidx, mo, inv), lambda f, w: jsc.strided_xpair_conv(
        f, jsidx, None, jinv, w, jmo)


@pytest.mark.parametrize("case", ["subm"] + IDS)
def test_sparse_conv_vjp_matches_jax_and_autograd(sparse, case):
    (nidx, mask, inv), jconv = _vjp_cases(sparse, case)
    K = nidx.shape[1]
    rng = np.random.RandomState(2)
    w = (rng.randn(K * CIN, COUT) * 0.1).astype(np.float32)
    g = rng.randn(nidx.shape[0], COUT).astype(np.float32)
    want_out, vjp = jax.vjp(jconv, jnp.asarray(sparse["feats"]), jnp.asarray(w))
    want_df, want_dw = vjp(jnp.asarray(g))

    grads = []
    for fn in (lambda f, ww: sparse_conv(f, nidx, ww, mask, inv),
               lambda f, ww: sparse_conv_reference(f, nidx, ww, mask)):
        f = torch.from_numpy(sparse["feats"]).requires_grad_()
        ww = torch.from_numpy(w).requires_grad_()
        out = fn(f, ww)
        out.backward(torch.from_numpy(g))
        grads.append((out.detach(), f.grad, ww.grad))
    (out, df, dw), (_, oracle_df, oracle_dw) = grads
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **GRAD_TOL)
    np.testing.assert_allclose(df.numpy(), np.asarray(want_df), **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **GRAD_TOL)
    np.testing.assert_allclose(df.numpy(), oracle_df.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), oracle_dw.numpy(), **GRAD_TOL)
    assert bool((df[~sparse["grid"].mask] == 0).all())


def test_dropped_sites_pass_no_gradient(sparse):
    """With the capacity below the site count, an input row whose every
    output site was dropped gets exactly zero d_feats."""
    (nidx, mask, inv), _ = _vjp_cases(sparse, "k3s2p1")
    starved = sparse["grid"].mask & (inv == SATURATED).all(1)
    assert int(starved.sum()) > 0
    f = torch.from_numpy(sparse["feats"]).requires_grad_()
    w = torch.randn(27 * CIN, COUT, generator=torch.Generator().manual_seed(3))
    sparse_conv(f, nidx, w, mask, inv).backward(
        torch.randn(nidx.shape[0], COUT, generator=torch.Generator().manual_seed(4)))
    assert bool((f.grad[starved] == 0).all())
    assert bool((f.grad[sparse["grid"].mask & ~starved] != 0).any(1).all())


def _counting(monkeypatch):
    calls = {"gather_conv": 0, "sparse_conv_wgrad": 0}
    for name in calls:
        fn = getattr(sc, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(sc, name, counted)
    return calls


@pytest.mark.parametrize("feats_grad", [True, False], ids=["feats", "weight_only"])
def test_the_backward_is_sparse_conv_fns(sparse, monkeypatch, feats_grad):
    """Forward one conv, backward d_feats (another conv, skipped when the
    features need no gradient, as the voxel features of conv_input) and
    d_weight (the weight-gradient op)."""
    (nidx, mask, inv), _ = _vjp_cases(sparse, "conv_out")
    calls = _counting(monkeypatch)
    f = torch.from_numpy(sparse["feats"]).requires_grad_(feats_grad)
    w = torch.ones(3 * CIN, COUT, requires_grad=True)
    out = sparse_conv(f, nidx, w, mask, inv)
    assert type(out.grad_fn).__name__ == "SparseConvFnBackward"
    assert calls == {"gather_conv": 1, "sparse_conv_wgrad": 0}
    out.sum().backward()
    assert calls == {"gather_conv": 1 + feats_grad, "sparse_conv_wgrad": 1}
    assert (f.grad is not None) == feats_grad and w.grad.shape == w.shape
