"""The transformer's fusion options, the FPN's extra levels, SECONDFPN
without the stride-1 conv and the coder's score threshold, each against its
JAX method at tiny shapes.

* ``channel_feature_norm`` (the four MLP-CNW activations, CNW,
  ModalityProjection), ``spatial_feature_norm`` and ``multi_modal_fusion``
  (linear, avg, cat and cat over ModalityProjection's pseudo features; the
  MLP and Fixed modal embeddings) under the flag pairs (1, 1), (1, 0) and
  (0, 1): the normed features, the fused map and the gradient of every
  parameter and of both inputs under a fixed cotangent.  The JAX module's
  variables are perturbed and carried over by ``jax_to_state_dict`` under
  the reference's names.
* FPN with ``num_outs`` above its levels (``add_extra_convs='on_output'``,
  with and without ``relu_before_extra_convs``, from ``start_level`` 1).
* SECONDFPN with ``use_conv_for_no_stride=False``, in eval mode (running
  statistics) and train mode (batch statistics and their update).
* ``NMSFreeCoder(score_threshold=...)``: a batch in which the threshold
  itself passes, one in which only a decayed rung does, one in which none
  does (every box kept).

Tolerance: atol/rtol 1e-4 on values (relative to their scale), 1e-4 of each
gradient's largest entry; masks and labels exactly.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from unibev_tpu.core.bbox.coders import NMSFreeCoder as JaxCoder
from unibev_tpu.models.necks.fpn import FPN as JaxFPN
from unibev_tpu.models.necks.fpn import SECONDFPN as JaxSECONDFPN
from unibev_tpu.models.transformer_fusion import \
    UniBEVTransformer as JaxTransformer

from torch_port_utils import perturb, port_state, t
from unibev_tpu_torch.core.bbox.coders import NMSFreeCoder, decay_ladder
from unibev_tpu_torch.models.necks.fpn import FPN, SECONDFPN
from unibev_tpu_torch.models.transformer_fusion import UniBEVTransformer

KEY = jax.random.PRNGKey(0)
C, BEV_H, BEV_W, B = 8, 3, 4, 2
FLAG_PAIRS = [(1.0, 1.0), (1.0, 0.0), (0.0, 1.0)]       # (l_flag, c_flag)
TFM = ("pts_bbox_head", "transformer")
TFM_T = "pts_bbox_head.transformer."


def _close_scaled(got, want, rel=1e-4):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * scale, rtol=rel)


def _close_grad(got, want, name, rel=1e-4):
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else got.numpy()
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-12),
                               err_msg=name)


class _Fusion(JaxTransformer):
    """The JAX transformer's three fusion methods alone, in order."""

    @fnn.compact
    def __call__(self, img, pts, l_flag, c_flag):
        img, pts = self.channel_feature_norm(img, pts, l_flag, c_flag)
        img, pts = self.spatial_feature_norm(img, pts, l_flag, c_flag)
        return img, pts, self.multi_modal_fusion(img, pts, l_flag, c_flag)


# (fusion_method, feature_norm, spatial_norm, use_modal_embeds)
CASES = [
    ("linear", "MLP_ChannelNormWeights", None, None),
    ("linear", "Leaky_ReLU_MLP_ChannelNormWeights", None, None),
    ("avg", "ELU_MLP_ChannelNormWeights", None, None),
    ("linear", "Sigmoid_MLP_ChannelNormWeights", None, None),
    ("cat", "ModalityProjection", None, None),
    ("linear", "ChannelNormWeights", "SpatialNormWeights", "MLP"),
    ("avg", None, "SpatialNormWeights", "Fixed"),
    ("cat", None, None, None),
    ("linear", "ChannelNormWeights", None, "Fixed"),
    ("avg", None, None, "MLP"),
]


def _case_id(case):
    return "-".join(str(c) for c in case)


@pytest.fixture(scope="module", params=CASES, ids=_case_id)
def fusion_pair(request):
    fusion, norm, spatial, embeds = request.param
    kw = dict(embed_dims=C, fusion_method=fusion, feature_norm=norm,
              spatial_norm=spatial, use_modal_embeds=embeds, bev_h=BEV_H,
              bev_w=BEV_W)
    rng = np.random.RandomState(request.param_index)
    img = rng.randn(B, BEV_H * BEV_W, C).astype(np.float32)
    pts = rng.randn(B, BEV_H * BEV_W, C).astype(np.float32)
    jm = _Fusion(**kw)
    variables = perturb(jm.init(KEY, jnp.asarray(img), jnp.asarray(pts),
                                jnp.float32(1), jnp.float32(1)), scale=0.3)
    tm = UniBEVTransformer(**kw, use_img=False, use_pts=False,
                           decoder=dict(num_layers=0))
    missing, unexpected = tm.load_state_dict(port_state(variables, TFM, TFM_T),
                                             strict=False)
    assert not unexpected and set(missing) == {"reference_points.weight",
                                               "reference_points.bias"}
    return jm, variables, tm, img, pts


@pytest.mark.parametrize("pair", FLAG_PAIRS, ids=["LC", "L", "C"])
def test_fusion_methods_match_jax(fusion_pair, pair):
    jm, variables, tm, img, pts = fusion_pair
    lf, cf = pair
    outs = jm.apply(variables, jnp.asarray(img), jnp.asarray(pts),
                    jnp.float32(lf), jnp.float32(cf))
    rng = np.random.RandomState(1)
    cots = tuple(rng.randn(*np.shape(o)).astype(np.float32) for o in outs)

    def f(params, a, b):
        o = jm.apply({"params": params}, a, b, jnp.float32(lf), jnp.float32(cf))
        return sum(jnp.vdot(x, jnp.asarray(w)) for x, w in zip(o, cots))

    # (cat fusion without a norm or an embedding has no parameter)
    jgrads, jd_img, jd_pts = jax.grad(f, argnums=(0, 1, 2))(
        variables.get("params", {}), jnp.asarray(img), jnp.asarray(pts))

    timg = t(img).requires_grad_()
    tpts = t(pts).requires_grad_()
    tm.zero_grad(set_to_none=True)
    l_t, c_t = torch.tensor(lf), torch.tensor(cf)
    a, b = tm.channel_feature_norm(timg, tpts, l_t, c_t)
    a, b = tm.spatial_feature_norm(a, b, l_t, c_t)
    fused = tm.multi_modal_fusion(a, b, l_t, c_t)
    for g, w in zip((a, b, fused), outs):
        assert tuple(g.shape) == np.shape(w)
        _close_scaled(g.detach().numpy(), w)
    sum((x * t(w)).sum() for x, w in zip((a, b, fused), cots)).backward()
    _close_grad(timg.grad, jd_img, "img")
    _close_grad(tpts.grad, jd_pts, "pts")
    want = port_state({"params": jgrads}, TFM, TFM_T)
    got = dict(tm.named_parameters())
    assert set(want) <= set(got)
    for name, w in want.items():
        _close_grad(got[name].grad, w, name)
    if lf != cf:
        # one-sided flags: every weight is exactly 1.0, so the weighting
        # norms' parameters get exactly zero gradient
        for name in want:
            if "channel_weights" in name or "spatial_weights" in name:
                assert got[name].grad is None or not got[name].grad.any(), name


def test_decay_ladder_is_the_jax_packages():
    assert decay_ladder(0.5)[:3] == pytest.approx([0.45, 0.405, 0.3645])
    assert decay_ladder(0.5)[-1] >= 0.01 > decay_ladder(0.5)[-1] * 0.9
    assert decay_ladder(0.011) == [] and len(decay_ladder(0.3)) == 32


def test_nms_free_coder_score_threshold():
    """Batch 0 clears the threshold itself, batch 1 only the fourth rung
    (0.5 * 0.9^4 = 0.328), batch 2 nothing at or above 0.01 (all kept)."""
    rng = np.random.RandomState(8)
    Q, ncls = 20, 10
    logits = np.empty((2, 3, Q, ncls), np.float32)
    logits[:, 0] = rng.uniform(-3, 1.5, (2, Q, ncls))
    # batch 1: five scores of 0.33-0.34 above a field of 0.30-0.32, so the
    # rung 0.328 keeps five of the top 12
    scores1 = rng.uniform(0.30, 0.32, (2, Q * ncls))
    scores1[:, :5] = rng.uniform(0.33, 0.34, (2, 5))
    logits[:, 1] = -np.log(1 / scores1 - 1).reshape(2, Q, ncls)
    logits[:, 2] = rng.uniform(-9, -6, (2, Q, ncls))
    box = (rng.randn(2, 3, Q, 10) * 5).astype(np.float32)
    kw = dict(pc_range=(-54, -54, -5, 54, 54, 3), max_num=12,
              score_threshold=0.5,
              post_center_range=(-61.2, -61.2, -10, 61.2, 61.2, 10))
    want = JaxCoder(**kw).decode(jnp.asarray(logits), jnp.asarray(box))
    got = NMSFreeCoder(**kw).decode(t(logits), t(box))
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("scores", "bboxes"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=1e-4)
    scores = got["scores"]
    assert (scores[0] > 0.5).any() and (scores[1] < 0.5).all()
    kept = NMSFreeCoder(**kw).score_mask(scores)
    assert int(kept[1].sum()) == 5 and bool(kept[2].all())
    assert bool((kept[0] == (scores[0] > 0.5)).all())


@pytest.mark.parametrize("cfg", [
    dict(in_channels=(16,), num_outs=2),
    dict(in_channels=(8, 16), num_outs=4, relu_before_extra_convs=True),
    dict(in_channels=(8, 16), num_outs=3, start_level=1,
         relu_before_extra_convs=False),
], ids=["one-extra", "two-extra-relu", "start1-no-relu"])
def test_fpn_extra_levels(cfg):
    rng = np.random.RandomState(6)
    xs = [rng.randn(2, 16, 12, 8).astype(np.float32),
          rng.randn(2, 8, 6, 16).astype(np.float32)][-len(cfg["in_channels"]):]
    cfg = dict(cfg, out_channels=C)
    jm = JaxFPN(**cfg)
    args = tuple(jnp.asarray(x) for x in xs)
    variables = perturb(jm.init(KEY, args))
    want = jm.apply(variables, args)
    tm = FPN(**cfg)
    tm.load_state_dict(port_state(variables, ("img_neck",), "img_neck."),
                       strict=True)
    with torch.inference_mode():
        got = tm(tuple(t(x).permute(0, 3, 1, 2) for x in xs))
    assert len(got) == len(want) == cfg["num_outs"]
    for g, w in zip(got, want):
        _close_scaled(g.permute(0, 2, 3, 1).numpy(), np.asarray(w))


def test_fpn_refuses_other_extra_convs():
    with pytest.raises(ValueError, match="on_output"):
        FPN(in_channels=(16,), num_outs=2, add_extra_convs="on_input")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_secondfpn_without_the_stride_one_conv(train):
    rng = np.random.RandomState(2)
    xs = (rng.randn(2, 8, 6, 16).astype(np.float32),
          rng.randn(2, 4, 3, 32).astype(np.float32))
    cfg = dict(in_channels=(16, 32), out_channels=(12, 12),
               upsample_strides=(1, 2), use_conv_for_no_stride=False)
    jm = JaxSECONDFPN(**cfg)
    jxs = tuple(jnp.asarray(x) for x in xs)
    variables = perturb(jm.init(KEY, jxs))
    if train:
        want, state = jm.apply(variables, jxs, train=True,
                               mutable=["batch_stats"])
    else:
        want = jm.apply(variables, jxs)
    sd = port_state(variables, ("pts_neck",), "pts_neck.")
    tm = SECONDFPN(**cfg)
    tm.load_state_dict(sd, strict=True)
    assert "deblocks.0.0.weight" not in sd and sd["deblocks.0.1.weight"].shape == (16,)
    tm.train(train)
    with torch.no_grad():
        got = tm(tuple(t(x).permute(0, 3, 1, 2) for x in xs))
    assert got.shape == (2, 16 + 12, 8, 6)
    _close_scaled(got.permute(0, 2, 3, 1).numpy(), want)
    if train:
        new = port_state({"batch_stats": state["batch_stats"]}, ("pts_neck",),
                         "pts_neck.")
        for k, v in new.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(tm.state_dict()[k].numpy(),
                                           v.numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=k)


def _head_cfg(fusion, dual):
    """A tiny LC head whose camera encoder samples two feature levels."""
    pc, dim, heads = (-9.6, -9.6, -2.0, 9.6, 9.6, 2.0), 16, 4
    dec = dim * (2 if fusion == "cat" else 1)

    def layer(levels, **sca):
        return dict(attn_cfgs=[dict(embed_dims=dim, num_heads=heads),
                               dict(deformable_attention=dict(
                                   embed_dims=dim, num_heads=heads,
                                   num_points=4, num_levels=levels), **sca)],
                    feedforward_channels=2 * dim)
    return dict(
        num_classes=10, in_channels=dim, num_query=12, bev_h=6, bev_w=6,
        dual_queries=dual,
        positional_encoding=dict(num_feats=dim // 2, row_num_embed=6,
                                 col_num_embed=6),
        transformer=dict(
            embed_dims=dim, num_cams=2, fusion_method=fusion,
            feature_norm=None if fusion == "cat" else "ChannelNormWeights",
            dual_queries=dual,
            img_encoder=dict(num_layers=1, pc_range=pc, num_points_in_pillar=2,
                             transformerlayers=layer(2, rebatch_k=36)),
            pts_encoder=dict(num_layers=1, pc_range=pc,
                             num_points_in_pillar_lidar=2,
                             transformerlayers=layer(1)),
            decoder=dict(num_layers=2, transformerlayers=dict(
                attn_cfgs=[dict(embed_dims=dec, num_heads=heads),
                           dict(embed_dims=dec, num_levels=1, num_heads=heads)],
                feedforward_channels=2 * dec))),
        bbox_coder=dict(post_center_range=(-12, -12, -4, 12, 12, 4),
                        pc_range=pc, max_num=6, num_classes=10))


@pytest.mark.parametrize("fusion,dual", [("linear", True), ("cat", False)],
                         ids=["dual-queries", "cat"])
def test_head_with_two_camera_levels(fusion, dual):
    """Two camera feature levels through the camera encoder (their level
    embeddings, K1 over both maps) beside one LiDAR map, against the JAX
    head: outputs, the fused map and decoded boxes."""
    from unibev_tpu.models.heads.unibev_head import UniBEVHead as JaxHead

    from unibev_tpu_torch.models.heads.unibev_head import UniBEVHead
    rng = np.random.RandomState(3)
    img = [rng.randn(1, 2, 4, 6, 16).astype(np.float32),
           rng.randn(1, 2, 2, 3, 16).astype(np.float32)]
    pts = [rng.randn(1, 6, 6, 16).astype(np.float32)]
    l2i = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    l2i[0, :, 0, 2], l2i[0, :, 1, 2] = 48.0, 32.0
    l2i[0, 0, :3, :3] = l2i[0, 0, :3, :3] @ np.array(
        [[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    l2i[0, 1, :3, :3] = l2i[0, 1, :3, :3] @ np.array(
        [[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32)
    jm = JaxHead(**_head_cfg(fusion, dual))
    jargs = ([jnp.asarray(f) for f in img], [jnp.asarray(f) for f in pts],
             jnp.asarray(l2i), (64, 96), jnp.float32(1.0), jnp.float32(1.0))
    variables = perturb(jm.init(KEY, *jargs))
    want = jm.apply(variables, *jargs)
    want_boxes = jm.apply(variables, want, method=JaxHead.get_bboxes)
    tm = UniBEVHead(**_head_cfg(fusion, dual), use_pts=True).eval()
    tm.load_state_dict(port_state(variables, ("pts_bbox_head",), "pts_bbox_head."),
                       strict=True)
    assert tm.transformer.img_level_embeds.shape == (2, 16)
    with torch.no_grad():
        got = tm([t(f) for f in img], [t(f) for f in pts], t(l2i), (64, 96))
    assert int(got["sca_overflow"]) == 0
    for k in ("all_cls_scores", "all_bbox_preds", "bev_embed"):
        _close_scaled(got[k].numpy(), want[k])
    boxes = tm.get_bboxes(got)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(boxes[k].numpy(), np.asarray(want_boxes[k]))
    _close_scaled(boxes["bboxes"].numpy(), want_boxes["bboxes"])
