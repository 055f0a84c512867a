"""Module parity: each port module against its JAX counterpart.

The JAX module is initialized, its variables are perturbed off their inits
(``perturb``) and carried into the port module through the full-model
converter ``jax_to_state_dict`` (``port_state``), which must load with
``strict=True``.  Both run on the same numpy inputs in f32 on the CPU.

Tolerance: atol/rtol 1e-4 unless stated.  Transformer blocks chain a few
matmuls, softmaxes and LayerNorms; the ResNet chains 16 bottlenecks, whose
outputs reach ~1e2, so it is compared relative to its output scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from unibev_tpu.core.bbox.coders import NMSFreeCoder as JaxCoder
from unibev_tpu.models.attention.deformable import MSDAttention as JaxMSDA
from unibev_tpu.models.attention.deformable import \
    SpatialCrossAttentionImg as JaxSCA
from unibev_tpu.models.backbones.resnet import ResNet as JaxResNet
from unibev_tpu.models.decoder import \
    DetectionTransformerDecoder as JaxDecoder
from unibev_tpu.models.encoders import BEVEncoderLayer as JaxEncoderLayer
from unibev_tpu.models.heads.unibev_head import UniBEVHead as JaxHead
from unibev_tpu.models.necks.fpn import FPN as JaxFPN

from torch_port_utils import perturb, port_state, t
from unibev_tpu_torch.core.bbox.coders import NMSFreeCoder
from unibev_tpu_torch.models.attention.deformable import (
    MSDAttention, SpatialCrossAttentionImg)
from unibev_tpu_torch.models.backbones.resnet import ResNet
from unibev_tpu_torch.models.decoder import DetectionTransformerDecoder
from unibev_tpu_torch.models.encoders import BEVEncoderLayer
from unibev_tpu_torch.models.heads.unibev_head import UniBEVHead
from unibev_tpu_torch.models.necks.fpn import FPN

TOL = dict(atol=1e-4, rtol=1e-4)
C, HEADS = 32, 4
ENC = ("pts_bbox_head", "transformer", "img_encoder", "layer0")
ENC_T = "pts_bbox_head.transformer.img_bev_encoder.layers.0."
KEY = jax.random.PRNGKey(0)


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval().requires_grad_(False)


def _sca_inputs(seed=0, B=1, Q=64, N=3, Z=2, V=30):
    rng = np.random.RandomState(seed)
    query = rng.randn(B, Q, C).astype(np.float32)
    value = rng.randn(B, N, V, C).astype(np.float32)
    ref = rng.uniform(0, 1, (B, N, Q, Z, 2)).astype(np.float32)
    hit = rng.rand(B, N, Q) < 0.4
    return query, value, ref, hit


def _topk(hit, K):
    return np.argsort(~hit, axis=-1, kind="stable")[..., :K].astype(np.int32)


def test_msda_attention():
    rng = np.random.RandomState(0)
    B, Q, shapes = 2, 20, ((5, 6), (3, 4))
    V = sum(h * w for h, w in shapes)
    query = rng.randn(B, Q, C).astype(np.float32)
    value = rng.randn(B, V, C).astype(np.float32)
    ref = rng.uniform(0, 1, (B, Q, 2, 2)).astype(np.float32)
    pos = rng.randn(B, Q, C).astype(np.float32)
    cfg = dict(embed_dims=C, num_heads=HEADS, num_levels=2, num_points=4)
    jm = JaxMSDA(**cfg)
    variables = perturb(jm.init(KEY, jnp.asarray(query), jnp.asarray(value),
                                jnp.asarray(ref), shapes))
    want = jm.apply(variables, jnp.asarray(query), jnp.asarray(value),
                    jnp.asarray(ref), shapes, query_pos=jnp.asarray(pos))
    tm = _load(MSDAttention(**cfg), port_state(variables, ENC + ("self_attn",),
                                               ENC_T + "attentions.0."))
    got = tm(t(query), t(value), t(ref), shapes, query_pos=t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rebatch_k", [0, 40], ids=["dense", "rebatch"])
def test_spatial_cross_attention_img(rebatch_k):
    query, value, ref, hit = _sca_inputs()
    N, Q = hit.shape[1:]
    cfg = dict(embed_dims=C, rebatch_k=rebatch_k,
               deformable_attention=dict(embed_dims=C, num_heads=HEADS,
                                         num_points=4, num_levels=1))
    shapes = ((5, 6),)
    topk = _topk(hit, rebatch_k) if rebatch_k else None
    if rebatch_k:
        assert rebatch_k < Q and hit.sum(-1).max() <= rebatch_k   # overflow 0
    jm = JaxSCA(**cfg)
    args = [jnp.asarray(a) for a in (query, value, ref, hit)]
    variables = perturb(jm.init(KEY, *args, shapes))
    want = jm.apply(variables, *args, shapes,
                    topk_idx=None if topk is None else jnp.asarray(topk))
    tm = _load(SpatialCrossAttentionImg(**cfg),
               port_state(variables, ENC + ("cross_attn",),
                          ENC_T + "attentions.1."))
    got = tm(t(query), t(value), t(ref), t(hit), shapes,
             topk_idx=None if topk is None else t(topk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bev_encoder_layer():
    query, value, ref, hit = _sca_inputs(1)
    rng = np.random.RandomState(1)
    bev_hw = (8, 8)
    pos = rng.randn(*query.shape).astype(np.float32)
    ys, xs = np.meshgrid((np.arange(8) + 0.5) / 8, (np.arange(8) + 0.5) / 8,
                         indexing="ij")
    ref_2d = np.stack([xs, ys], -1).reshape(64, 1, 2).astype(np.float32)
    topk = _topk(hit, 40)
    tsa = dict(type="MultiScaleDeformableAttention", embed_dims=C,
               num_heads=HEADS, num_levels=1)
    sca = dict(deformable_attention=dict(embed_dims=C, num_heads=HEADS,
                                         num_points=4, num_levels=1),
               rebatch_k=40)
    shapes = ((5, 6),)
    jm = JaxEncoderLayer(embed_dims=C, ffn_dims=2 * C, tsa_cfg=tsa,
                         sca_cfg=sca, modality="img")
    args = [jnp.asarray(a) for a in (query, value, pos, ref_2d)]
    rest = [jnp.asarray(a) for a in (ref, hit)]
    variables = perturb(jm.init(KEY, *args, bev_hw, *rest, shapes,
                                topk_idx=jnp.asarray(topk)))
    want = jm.apply(variables, *args, bev_hw, *rest, shapes,
                    topk_idx=jnp.asarray(topk))
    tm = _load(BEVEncoderLayer(C, 2 * C, tsa, sca), port_state(variables, ENC, ENC_T))
    got = tm(t(query), t(value), t(pos), t(ref_2d), bev_hw, t(ref), t(hit),
             shapes, topk_idx=t(topk))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decoder_with_box_refinement():
    rng = np.random.RandomState(2)
    B, Nq, bev = 1, 12, (8, 8)
    query = rng.randn(B, Nq, C).astype(np.float32)
    pos = rng.randn(B, Nq, C).astype(np.float32)
    value = rng.randn(B, 64, C).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (B, Nq, 3)).astype(np.float32)
    # the same fixed linear reg branches on both sides
    reg_w = [rng.randn(C, 10).astype(np.float32) * 0.1 for _ in range(2)]
    cfg = dict(num_layers=2, embed_dims=C, num_heads=HEADS, ffn_dims=2 * C,
               cross_attn_cfg=dict(embed_dims=C, num_levels=1, num_heads=HEADS))
    jm = JaxDecoder(**cfg)
    args = [jnp.asarray(a) for a in (query, value, pos, ref)]
    jreg = [lambda x, w=w: x @ jnp.asarray(w) for w in reg_w]
    variables = perturb(jm.init(KEY, *args, (bev,), reg_branches=jreg))
    want_states, want_refs = jm.apply(variables, *args, (bev,), reg_branches=jreg)
    tm = _load(DetectionTransformerDecoder(**cfg),
               port_state(variables, ("pts_bbox_head", "transformer", "decoder"),
                          "pts_bbox_head.transformer.decoder."))
    treg = [lambda x, w=w: x @ t(w) for w in reg_w]
    states, refs = tm(t(query), t(value), t(pos), t(ref), (bev,),
                      reg_branches=treg)
    np.testing.assert_allclose(states.numpy(), np.asarray(want_states), **TOL)
    np.testing.assert_allclose(refs.numpy(), np.asarray(want_refs), **TOL)


def _head_cfg():
    pc = (-9.6, -9.6, -2.0, 9.6, 9.6, 2.0)
    layer = dict(attn_cfgs=[dict(embed_dims=C, num_heads=HEADS, num_levels=1),
                            dict(deformable_attention=dict(
                                embed_dims=C, num_heads=HEADS, num_points=4,
                                num_levels=1), rebatch_k=40)],
                 feedforward_channels=2 * C)
    return dict(
        num_classes=10, in_channels=C, num_query=12, bev_h=8, bev_w=8,
        positional_encoding=dict(num_feats=C // 2, row_num_embed=8,
                                 col_num_embed=8),
        transformer=dict(
            embed_dims=C, num_cams=2, fusion_method="linear",
            feature_norm="ChannelNormWeights",
            img_encoder=dict(num_layers=1, pc_range=pc, num_points_in_pillar=2,
                             transformerlayers=layer),
            decoder=dict(num_layers=2, transformerlayers=dict(
                attn_cfgs=[dict(embed_dims=C, num_heads=HEADS),
                           dict(embed_dims=C, num_levels=1, num_heads=HEADS)],
                feedforward_channels=2 * C))),
        bbox_coder=dict(post_center_range=(-12, -12, -4, 12, 12, 4),
                        pc_range=pc, max_num=6, num_classes=10))


def test_head_forward_and_get_bboxes():
    rng = np.random.RandomState(3)
    feats = rng.randn(1, 2, 4, 6, C).astype(np.float32)
    l2i = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    l2i[0, :, 0, 2] = 48.0          # principal point: pillars project in view
    l2i[0, :, 1, 2] = 32.0
    l2i[0, 1, :3, :3] = l2i[0, 1, :3, :3] @ np.array(
        [[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32)
    l2i[0, 0, :3, :3] = l2i[0, 0, :3, :3] @ np.array(
        [[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    img_shape = (64, 96)
    jm = JaxHead(**_head_cfg(), use_pts=False)   # camera only
    jargs = ([jnp.asarray(feats)], None, jnp.asarray(l2i), img_shape,
             jnp.float32(0.0), jnp.float32(1.0))
    variables = perturb(jm.init(KEY, *jargs))
    want = jm.apply(variables, *jargs)
    want_boxes = jm.apply(variables, want, method=JaxHead.get_bboxes)
    tm = _load(UniBEVHead(**_head_cfg()),
               port_state(variables, ("pts_bbox_head",), "pts_bbox_head."))
    got = tm([t(feats)], None, t(l2i), img_shape)
    assert int(got["sca_overflow"]) == 0
    for k in ("all_cls_scores", "all_bbox_preds", "bev_embed"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    boxes = tm.get_bboxes(got)
    np.testing.assert_array_equal(boxes["labels"].numpy(),
                                  np.asarray(want_boxes["labels"]))
    np.testing.assert_array_equal(boxes["valid"].numpy(),
                                  np.asarray(want_boxes["valid"]))
    for k in ("scores", "bboxes"):
        np.testing.assert_allclose(boxes[k].numpy(), np.asarray(want_boxes[k]),
                                   **TOL)


@pytest.mark.parametrize("post_center_range", [None, (-6, -6, -10, 6, 6, 10)],
                         ids=["all", "range"])
def test_nms_free_coder(post_center_range):
    rng = np.random.RandomState(4)
    cls = rng.randn(2, 2, 30, 10).astype(np.float32) * 2
    box = rng.randn(2, 2, 30, 10).astype(np.float32) * 5
    kw = dict(pc_range=(-54, -54, -5, 54, 54, 3),
              post_center_range=post_center_range, max_num=20)
    want = JaxCoder(**kw).decode(jnp.asarray(cls), jnp.asarray(box))
    got = NMSFreeCoder(**kw).decode(t(cls), t(box))
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("scores", "bboxes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def _resnet_against_jax(cfg):
    """The port's ResNet against the JAX ResNet on one tiny image batch:
    each output at 1e-4 of its largest value."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 64, 96, 3).astype(np.float32)
    jm = JaxResNet(**cfg)
    variables = perturb(jm.init(KEY, jnp.asarray(x)), scale=0.01)
    want = jm.apply(variables, jnp.asarray(x))
    tm = _load(ResNet(**cfg), port_state(variables, ("img_backbone",),
                                         "img_backbone."))
    tm.to(memory_format=torch.channels_last)
    got = tm(t(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy() / scale,
                                   w / scale, atol=1e-4, rtol=0)


@pytest.mark.parametrize("style", ["caffe", "pytorch"])
def test_resnet50_with_dcn_stage4(style):
    """Pytorch style strides the 3x3, here the DCNv2 of stage 4 too."""
    _resnet_against_jax(dict(depth=50, out_indices=(2, 3), style=style,
                             stage_with_dcn=(False, False, False, True),
                             dcn=dict(type="DCNv2", deform_groups=1)))


def test_resnet26_matches_jax():
    _resnet_against_jax(dict(depth=26, out_indices=(0, 1, 2, 3),
                             stage_with_dcn=(False, False, True, True),
                             dcn=dict(type="DCNv2", deform_groups=1)))


def _block_pattern(state):
    """{(stage, 'first' / 'rest'): key suffixes} and {stage: blocks} of a
    ResNet state dict."""
    pattern, blocks = {}, {}
    for key in state:
        if not key.startswith("layer"):
            pattern.setdefault("stem", set()).add(key)
            continue
        layer, block, rest = key.split(".", 2)
        stage = int(layer[len("layer"):])
        blocks[stage] = max(blocks.get(stage, 0), int(block) + 1)
        pattern.setdefault((stage, "first" if block == "0" else "rest"),
                           set()).add(rest)
    return pattern, blocks


@pytest.mark.parametrize("style", ["caffe", "pytorch"])
def test_resnet152_builds_as_resnet101(style):
    """Depth 152 on the meta device: (3, 8, 36, 3) blocks, each stage's
    first and later blocks with the keys of a depth-101 build (mmdet's
    names, whatever the style)."""
    cfg = dict(out_indices=(3,), stage_with_dcn=(False, False, True, True),
               dcn=dict(type="DCNv2", deform_groups=1))
    with torch.device("meta"):
        deep = ResNet(depth=152, style=style, **cfg).state_dict()
        ref = ResNet(depth=101, **cfg).state_dict()
    pattern, blocks = _block_pattern(deep)
    ref_pattern, ref_blocks = _block_pattern(ref)
    assert blocks == {1: 3, 2: 8, 3: 36, 4: 3}
    assert ref_blocks == {1: 3, 2: 4, 3: 23, 4: 3}
    assert pattern == ref_pattern
    assert all(v.shape == ref[k].shape for k, v in deep.items() if k in ref)


def test_resnet_refuses_an_unknown_style():
    with pytest.raises(ValueError, match="style"):
        ResNet(depth=50, style="tf")


def test_fpn_two_levels():
    rng = np.random.RandomState(6)
    c4 = rng.randn(2, 8, 12, 64).astype(np.float32)
    c5 = rng.randn(2, 4, 6, 128).astype(np.float32)
    cfg = dict(in_channels=(64, 128), out_channels=C, num_outs=2)
    jm = JaxFPN(**cfg)
    args = (jnp.asarray(c4), jnp.asarray(c5))
    variables = perturb(jm.init(KEY, args))
    want = jm.apply(variables, args)
    tm = _load(FPN(**cfg), port_state(variables, ("img_neck",), "img_neck."))
    got = tm(tuple(t(a).permute(0, 3, 1, 2) for a in (c4, c5)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   **TOL)
