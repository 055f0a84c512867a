"""LiDAR branch modules, each against its JAX counterpart.

The JAX module is initialized (jitted), its variables are perturbed off
their inits, running statistics included, so that no BatchNorm is the
identity (``perturb``), and carried into the port module through the
full-model converter ``jax_to_state_dict`` (``port_state``), which must
load with ``strict=True``.  Both run on the same numpy inputs in f32 on the
CPU.  Tolerance: atol/rtol 1e-4, relative to the output scale where the
outputs grow past 1 (the sparse encoder's residual blocks, SECOND).

* ``SparseEncoder``: a [25, 32, 32] grid with batch 2 and capacities below
  the active sites, so the strided convs overflow (the smallest keys are
  kept, as in the JAX package) and the output stacks channel ``c * Dz + d``;
* ``SECOND`` and ``SECONDFPN``, which holds the transposed conv's kernel
  flip of the converter: flax's ``ConvTranspose`` mirrors the kernel that
  torch's ``ConvTranspose2d`` applies;
* ``SpatialCrossAttentionPts`` and ``PtsEncoder`` on a 12x10 LiDAR map.
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp
from unibev_tpu.models.attention.deformable import \
    SpatialCrossAttentionPts as JaxSCAPts
from unibev_tpu.models.backbones.second import SECOND as JaxSECOND
from unibev_tpu.models.encoders import PtsEncoder as JaxPtsEncoder
from unibev_tpu.models.middle_encoder import SparseEncoder as JaxSparseEncoder
from unibev_tpu.models.necks.fpn import SECONDFPN as JaxSECONDFPN

from test_sparse_conv import make_sparse
from torch_port_utils import perturb, port_state, t
from unibev_tpu_torch.models.attention.deformable import \
    SpatialCrossAttentionPts
from unibev_tpu_torch.models.backbones.second import SECOND
from unibev_tpu_torch.models.encoders import PtsEncoder
from unibev_tpu_torch.models.middle_encoder import SparseEncoder
from unibev_tpu_torch.models.necks.fpn import SECONDFPN

TOL = dict(atol=1e-4, rtol=1e-4)
C, HEADS = 32, 4
KEY = jax.random.PRNGKey(0)
PTS_ENC = ("pts_bbox_head", "transformer", "pts_encoder")
PTS_ENC_T = "pts_bbox_head.transformer.pts_bev_encoder."


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval().requires_grad_(False)


def _init(module, *args):
    return perturb(jax.jit(module.init)(KEY, *args))


def _close_scaled(got, want, rel=1e-4):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=rel)


def test_sparse_encoder_matches_jax():
    B, shape = 2, (25, 32, 32)
    cfg = dict(in_channels=5, sparse_shape=shape, output_channels=16,
               encoder_channels=((8, 8, 16), (16, 16, 32), (32, 32, 32),
                                 (32, 32)),
               encoder_paddings=((0, 0, 1), (0, 0, 1), (0, 0, (0, 1, 1)),
                                 (0, 0)),
               capacities=(1200, 900, 300, 120))
    rng = np.random.RandomState(0)
    feats, coords, mask = make_sparse(rng, B, *shape, 5, 1000, 1200)
    jm = JaxSparseEncoder(**cfg)
    args = (jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(mask))
    variables = perturb(jax.jit(functools.partial(jm.init, batch_size=B))(
        KEY, *args))
    want = np.asarray(jax.jit(functools.partial(jm.apply, batch_size=B))(
        variables, *args))
    tm = _load(SparseEncoder(**cfg), port_state(
        variables, ("pts_middle_encoder",), "pts_middle_encoder."))
    with torch.inference_mode():
        bev, overflow = tm(t(feats), t(coords), t(mask), B)
    assert want.shape == (B, 4, 4, 16) and bev.shape == (B, 16, 4, 4)
    assert int(overflow[0]) > 0 and int(overflow[1]) > 0
    _close_scaled(bev.permute(0, 2, 3, 1).numpy(), want)


def test_second_matches_jax():
    x = np.random.RandomState(1).randn(2, 16, 12, 32).astype(np.float32)
    cfg = dict(in_channels=32, out_channels=(32, 64), layer_nums=(1, 1),
               layer_strides=(1, 2))
    jm = JaxSECOND(**cfg)
    variables = _init(jm, jnp.asarray(x))
    want = jm.apply(variables, jnp.asarray(x))
    tm = _load(SECOND(**cfg), port_state(variables, ("pts_backbone",),
                                         "pts_backbone."))
    with torch.inference_mode():
        got = tm(t(x).permute(0, 3, 1, 2))
    assert len(got) == 2
    for g, w in zip(got, want):
        _close_scaled(g.permute(0, 2, 3, 1).numpy(), np.asarray(w))


def test_secondfpn_matches_jax_with_the_deconv_flip():
    rng = np.random.RandomState(2)
    xs = (rng.randn(2, 8, 6, 32).astype(np.float32),
          rng.randn(2, 4, 3, 64).astype(np.float32))
    cfg = dict(in_channels=(32, 64), out_channels=(16, 16),
               upsample_strides=(1, 2))
    jm = JaxSECONDFPN(**cfg)
    jxs = tuple(jnp.asarray(x) for x in xs)
    variables = _init(jm, jxs)
    want = np.asarray(jm.apply(variables, jxs))
    state = port_state(variables, ("pts_neck",), "pts_neck.")
    tm = _load(SECONDFPN(**cfg), state)
    with torch.inference_mode():
        got = tm(tuple(t(x).permute(0, 3, 1, 2) for x in xs))
    assert got.shape == (2, 32, 8, 6)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    # without the flip the up-sampled half is mirrored in every 2x2 block
    state["deblocks.1.0.weight"] = state["deblocks.1.0.weight"].flip(2, 3)
    tm.load_state_dict(state, strict=True)
    with torch.inference_mode():
        unflipped = tm(tuple(t(x).permute(0, 3, 1, 2) for x in xs))
    assert not np.allclose(unflipped[:, 16:].permute(0, 2, 3, 1).numpy(),
                           want[..., 16:], **TOL)


def _pts_inputs(seed=3, B=2, Q=64, V_hw=(12, 10), Z=2):
    rng = np.random.RandomState(seed)
    query = rng.randn(B, Q, C).astype(np.float32)
    value = rng.randn(B, V_hw[0] * V_hw[1], C).astype(np.float32)
    ref = np.broadcast_to(rng.uniform(0, 1, (B, Q, 1, 2)),
                          (B, Q, Z, 2)).astype(np.float32)
    return query, value, ref


def test_spatial_cross_attention_pts_matches_jax():
    query, value, ref = _pts_inputs()
    da = dict(embed_dims=C, num_heads=HEADS, num_points=4, num_levels=1)
    jm = JaxSCAPts(embed_dims=C, deformable_attention=da)
    args = (jnp.asarray(query), jnp.asarray(value), jnp.asarray(ref))
    variables = perturb(jax.jit(functools.partial(
        jm.init, spatial_shapes=((12, 10),)))(KEY, *args))
    want = jm.apply(variables, *args, ((12, 10),))
    tm = _load(SpatialCrossAttentionPts(C, da), port_state(
        variables, PTS_ENC + ("layer0", "cross_attn"),
        PTS_ENC_T + "layers.0.attentions.1."))
    with torch.inference_mode():
        got = tm(t(query), t(value), t(ref), ((12, 10),))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pts_encoder_matches_jax():
    bev_h = bev_w = 8
    rng = np.random.RandomState(4)
    query = rng.randn(1, bev_h * bev_w, C).astype(np.float32)
    pos = rng.randn(1, bev_h * bev_w, C).astype(np.float32)
    value = rng.randn(1, 12 * 10, C).astype(np.float32)
    cfg = dict(num_layers=2, pc_range=(-9.6, -9.6, -2.0, 9.6, 9.6, 2.0),
               num_points_in_pillar_lidar=2, embed_dims=C, ffn_dims=2 * C,
               tsa_cfg=dict(embed_dims=C, num_heads=HEADS, num_levels=1),
               sca_cfg=dict(deformable_attention=dict(
                   embed_dims=C, num_heads=HEADS, num_points=4, num_levels=1)))
    jm = JaxPtsEncoder(**cfg)
    args = (jnp.asarray(query), jnp.asarray(value), jnp.asarray(pos))
    static = dict(bev_h=bev_h, bev_w=bev_w, value_shapes=((12, 10),))
    variables = perturb(jax.jit(functools.partial(jm.init, **static))(KEY, *args))
    want = jax.jit(functools.partial(jm.apply, **static))(variables, *args)
    tm = _load(PtsEncoder(**cfg), port_state(variables, PTS_ENC, PTS_ENC_T))
    with torch.inference_mode():
        got = tm(t(query), t(value), t(pos), bev_h, bev_w, ((12, 10),))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
