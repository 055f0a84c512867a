"""The tiny LC model in a fusion variant, in both packages: the shared body
of tests/test_torch_fusion_{avg,cat,dual}.py, one file a variant so that
``--dist loadfile`` puts each variant's JAX compiles on its own worker.

The tiny LC config of tests/test_detector.py (2 cameras, 8x8 BEV, depth-50
backbone with DCN in stage 4, a [25, 32, 32] voxel grid), its camera
cross-attention rebatched to 16 queries per camera as in
tests/test_torch_detector.py, in the variant's form:

* ``avg``: avg fusion, no feature norm (configs/unibev/*_avg_256_*);
* ``cat``: cat fusion, no feature norm, the decoder at twice the width
  (configs/unibev/*_cat_128_*; tests/test_detector.py::test_fusion_variants);
* ``dual``: CNW linear fusion with dual queries
  (configs/unibev/*_dual_queries_*).

The JAX model's variables are perturbed and carried over with
``jax_to_state_dict`` (``strict=True``).  Under each forced pair of flags,
(1, 1), (1, 0) and (0, 1), one jitted JAX function gives the head's
outputs, the decoded boxes, every loss term and the gradient of every
parameter (``train=False``: no GridMask, dropout or modality draw); the
port runs the same in eval mode with gradients on.

A gradient is compared where the model is differentiable at float32
precision: a ReLU input within ``KINK`` of 0 can fall on either side of
the kink in the two packages' roundings, and the gradient of everything
upstream of it then differs by that element's share.  So the variables are
perturbed with the first seed in ``SEEDS`` for which every ReLU input of
the port's LiDAR branch (sparse encoder, SECOND, SECONDFPN), the deepest
chain of the model, stays ``KINK`` or more from 0 (exact zeros aside).
(With seed 0 one input of the dual-queries model's ``encoder_layer2.1.bn1``
lies at 2.6e-7, and the conv weights below it differed from JAX by up to
4e-3 of their largest gradient, while the port in float64 agreed with the
port in float32 to 1e-6.)
"""

from __future__ import annotations

import contextlib
import copy
import functools
from unittest import mock

import numpy as np
import torch

import jax
import jax.numpy as jnp
from unibev_tpu.models.detectors.unibev import UniBEV as JaxUniBEV

from test_detector import tiny_batch as jax_tiny_batch
from test_detector import tiny_model_cfg as jax_tiny_model_cfg
from torch_port_utils import perturb, t
from unibev_tpu_torch.flagship import build_model, tiny_model_cfg
from unibev_tpu_torch.utils.convert_jax import jax_to_state_dict

TOL = dict(atol=1e-4, rtol=1e-4)
LC_KEYS = ("img", "points", "points_mask", "lidar2img", "gt_bboxes",
           "gt_labels", "gt_valid")
FLAG_PAIRS = [(1.0, 1.0), (1.0, 0.0), (0.0, 1.0)]       # (l_flag, c_flag)
FLAG_IDS = ["LC", "L", "C"]
SEEDS = range(8)   # perturb's seeds for the JAX variables, tried in order
KINK = 1e-6        # the closest a ReLU input may lie to 0 (exact zeros aside)


@contextlib.contextmanager
def relu_inputs(model):
    """Record the smallest nonzero |input| of every ReLU of the LiDAR branch
    (``torch.relu`` in the sparse encoder, ``nn.ReLU`` modules in SECOND and
    SECONDFPN) while the block runs; yields a list of those minima."""
    seen = []

    def note(x):
        a = x.detach().abs()
        a = a[a > 0]
        if a.numel():
            seen.append(float(a.min()))

    relu = torch.relu
    hooks = [m.register_forward_pre_hook(lambda m, args: note(args[0]))
             for name in ("pts_backbone", "pts_neck")
             for m in getattr(model, name).modules()
             if isinstance(m, torch.nn.ReLU)]
    try:
        with mock.patch.object(torch, "relu", lambda x: (note(x), relu(x))[1]):
            yield seen
    finally:
        for h in hooks:
            h.remove()


def variant_cfg(variant: str) -> dict:
    """The tests' tiny LC config in ``variant``'s form."""
    if variant == "dual":
        cfg = jax_tiny_model_cfg()
        cfg["pts_bbox_head"]["dual_queries"] = True
        cfg["pts_bbox_head"]["transformer"]["dual_queries"] = True
    else:
        cfg = jax_tiny_model_cfg(fusion=variant, feature_norm=None)
    cfg = copy.deepcopy(cfg)
    tfm = cfg["pts_bbox_head"]["transformer"]
    tfm["img_encoder"]["transformerlayers"]["attn_cfgs"][1]["rebatch_k"] = 16
    if variant == "cat":
        dec = tfm["decoder"]["transformerlayers"]
        dec["attn_cfgs"][0]["embed_dims"] = 64
        dec["attn_cfgs"][1]["embed_dims"] = 64
        dec["feedforward_channels"] = 128
    return cfg


PORT_TINY = {"avg": dict(fusion="avg", feature_norm=None),
             "cat": dict(fusion="cat", feature_norm=None),
             "dual": dict(dual_queries=True)}


def check_tiny_cfg(variant: str):
    """The port's ``tiny_model_cfg`` (which chip_smoke.py runs on the card)
    in ``variant``'s form is the config held against JAX here."""
    assert tiny_model_cfg(use_lidar=True, **PORT_TINY[variant]) == \
        variant_cfg(variant)


def run_pair(variant: str) -> dict:
    """Both packages on the tiny LC model in ``variant``'s form: per pair of
    flags the JAX and port head outputs, decoded boxes, losses and
    gradients (port names), and the port's LC ``predict``."""
    cfg = variant_cfg(variant)
    jbatch = jax_tiny_batch(np.random.RandomState(0))
    jbatch = {k: jbatch[k] for k in LC_KEYS}
    jm = JaxUniBEV(**cfg)
    init = jax.jit(functools.partial(jm.init, train=False))(
        dict(params=jax.random.PRNGKey(0), gridmask=jax.random.PRNGKey(1)),
        jbatch)
    tm = build_model(cfg, "cpu", seed=1, train=True)
    tm.eval()                    # no GridMask, no dropout; gradients stay on
    tbatch = {k: t(v) for k, v in jbatch.items()}
    for seed in SEEDS:
        variables = perturb(init, seed=seed, scale=0.01)
        tm.load_state_dict(jax_to_state_dict(variables), strict=True)
        with torch.no_grad(), relu_inputs(tm) as seen:
            tm.extract_pts_feat(tbatch["points"], tbatch["points_mask"])
        assert len(seen) > 20
        if min(seen) >= KINK:
            break
    else:
        raise AssertionError(f"no seed in {SEEDS} keeps the ReLU inputs "
                             f"{KINK} from their kink")

    def loss_fn(params, l_flag, c_flag):
        v = {**variables, "params": params}
        img = jm.apply(v, jbatch["img"], method=JaxUniBEV.extract_img_feat)
        pts = jm.apply(v, jbatch["points"], jbatch["points_mask"],
                       method=JaxUniBEV.extract_pts_feat)
        preds = jm.apply(v, img, pts, l_flag, c_flag,
                         method=lambda m, *a: m.head(
                             a[0], a[1], jbatch["lidar2img"], m.img_shape,
                             a[2], a[3], deterministic=True))
        losses = jm.apply(v, jbatch, preds, method=JaxUniBEV.loss)
        boxes = jm.apply(v, jax.lax.stop_gradient(preds),
                         method=lambda m, p: m.head.get_bboxes(p))
        return sum(losses.values()), (losses, preds, boxes)

    run = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    jax_out = {}
    for pair in FLAG_PAIRS:
        (_, (losses, preds, boxes)), grads = run(
            variables["params"], jnp.float32(pair[0]), jnp.float32(pair[1]))
        jax_out[pair] = dict(
            losses={k: float(v) for k, v in losses.items()},
            preds={k: np.asarray(preds[k]) for k in ("all_cls_scores",
                                                     "all_bbox_preds",
                                                     "bev_embed")},
            boxes={k: np.asarray(v) for k, v in boxes.items()},
            grads=jax_to_state_dict({"params": grads}))

    port_out = {}
    for pair in FLAG_PAIRS:
        tm.zero_grad(set_to_none=True)
        img = tm.extract_img_feat(tbatch["img"])
        pts, _ = tm.extract_pts_feat(tbatch["points"], tbatch["points_mask"])
        preds = tm.pts_bbox_head(img, pts, tbatch["lidar2img"], tm.img_shape,
                                 torch.tensor(pair[0]), torch.tensor(pair[1]))
        losses = tm.loss(tbatch, preds)
        sum(losses.values()).backward()
        with torch.no_grad():
            boxes = tm.pts_bbox_head.get_bboxes(preds)
        port_out[pair] = dict(
            losses={k: v.item() for k, v in losses.items()},
            preds={k: preds[k].detach() for k in ("all_cls_scores",
                                                  "all_bbox_preds",
                                                  "bev_embed")},
            boxes=boxes, sca_overflow=int(preds["sca_overflow"]),
            grads={n: None if p.grad is None else p.grad.clone()
                   for n, p in tm.named_parameters()})
    predict = tm.predict({k: tbatch[k] for k in LC_KEYS[:4]})
    return dict(model=tm, seed=seed, jax=jax_out, port=port_out,
                predict=predict)


def check_head_outputs(pair_run, pair):
    want, got = pair_run["jax"][pair], pair_run["port"][pair]
    for k, w in want["preds"].items():
        assert tuple(got["preds"][k].shape) == w.shape, k
        np.testing.assert_allclose(got["preds"][k].numpy(), w, **TOL, err_msg=k)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got["boxes"][k].numpy(), want["boxes"][k])
    for k in ("scores", "bboxes"):
        np.testing.assert_allclose(got["boxes"][k].numpy(), want["boxes"][k],
                                   **TOL, err_msg=k)
    assert got["sca_overflow"] == 0


def check_predict(pair_run):
    """LC predict (flags from the inputs present) is the (1, 1) decode."""
    got, want = pair_run["predict"], pair_run["jax"][(1.0, 1.0)]["boxes"]
    assert int(got["sca_overflow"]) == 0 and got["bboxes"].shape == (1, 16, 9)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for k in ("scores", "bboxes"):
        np.testing.assert_allclose(got[k].numpy(), want[k], **TOL, err_msg=k)


def check_losses(pair_run, pair):
    want, got = pair_run["jax"][pair]["losses"], pair_run["port"][pair]["losses"]
    assert set(got) == set(want) == {"loss_cls", "loss_bbox", "d0.loss_cls",
                                     "d0.loss_bbox"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def check_gradients(pair_run, pair, rel=1e-3):
    """Every parameter's gradient within ``rel`` of its largest entry (a
    gradient that is exactly 0 in JAX must be 0: a dropped branch's)."""
    want, got = pair_run["jax"][pair]["grads"], pair_run["port"][pair]["grads"]
    assert set(got) <= set(want)
    for name, g in got.items():
        w = want[name].numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, w, rtol=rel, atol=rel * np.abs(w).max(),
                                   err_msg=name)
    live = [n for n, g in got.items() if g is not None and g.any()]
    assert any(n.startswith("pts_bbox_head.transformer.decoder") for n in live)
    dropped = {(1.0, 0.0): "img_backbone", (0.0, 1.0): "pts_middle_encoder"}
    if pair in dropped:
        assert not any(n.startswith(dropped[pair]) for n in live)
    else:
        assert {n.split(".")[0] for n in live} >= {"img_backbone",
                                                   "pts_middle_encoder"}
