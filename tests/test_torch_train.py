"""The training slice end to end: the tiny camera-only model's losses and
gradients, JAX against the port.

The tiny C model of tests/test_detector.py (2 cameras, 8x8 BEV, depth-50
backbone with DCN in stage 4, frozen stem and stage 1, SCA rebatched to 16)
with perturbed JAX variables carried into the port's training build
(float32 parameters).  Both run with train mode off, so neither GridMask nor
dropout draws (in C mode the modality flags are fixed): every loss term and
the gradient of every parameter must agree with ``jax.grad`` of the JAX
loss.  JAX gradients map to port names through ``jax_to_state_dict``, since
gradients have the parameters' tree.  Perturbed weights make every
Hungarian optimum unique, so scipy and the in-graph solver agree.

Tolerances: losses rtol 1e-5; gradients rtol 1e-3 of each parameter's
largest gradient (float32 through the depth-50 backbone, one encoder and two
decoder layers).
"""

import numpy as np
import pytest
import torch

import jax
from unibev_tpu.models.detectors.unibev import UniBEV as JaxUniBEV

from test_detector import tiny_batch as jax_tiny_batch
from torch_port_utils import perturb, t
from unibev_tpu_torch.flagship import build_model, tiny_batch, tiny_model_cfg
from unibev_tpu_torch.parallel.train_state import make_optimizer, train_step
from unibev_tpu_torch.utils.convert_jax import jax_to_state_dict

KEYS = ("img", "lidar2img", "gt_bboxes", "gt_labels", "gt_valid")


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = tiny_model_cfg()
    jbatch = jax_tiny_batch(np.random.RandomState(0))
    jbatch = {k: jbatch[k] for k in KEYS}
    jm = JaxUniBEV(**cfg)
    variables = perturb(jm.init(
        dict(params=jax.random.PRNGKey(0), gridmask=jax.random.PRNGKey(1)),
        jbatch, train=False), scale=0.01)

    def loss_fn(params):
        v = {**variables, "params": params}
        preds = jm.apply(v, jbatch, train=False)
        losses = jm.apply(v, jbatch, preds, method=JaxUniBEV.loss)
        return sum(losses.values()), losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])

    tm = build_model(cfg, "cpu", seed=1, train=True)
    tm.load_state_dict(jax_to_state_dict(variables), strict=True)
    tm.eval()                    # no GridMask, no dropout; gradients stay on
    tbatch = {k: t(v) for k, v in jbatch.items()}
    tlosses = tm.loss(tbatch, tm(tbatch))
    sum(tlosses.values()).backward()
    tlosses = {k: v.detach() for k, v in tlosses.items()}
    return dict(jm=jm, variables=variables, jlosses=jlosses, jgrads=jgrads,
                tm=tm, tlosses=tlosses)


def test_every_loss_term_matches(tiny_pair):
    jl, tl = tiny_pair["jlosses"], tiny_pair["tlosses"]
    assert set(tl) == set(jl) == {"loss_cls", "loss_bbox", "d0.loss_cls",
                                  "d0.loss_bbox"}
    for k in jl:
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-5,
                                   err_msg=k)


def test_every_gradient_matches(tiny_pair):
    want = jax_to_state_dict({"params": tiny_pair["jgrads"]})
    params = dict(tiny_pair["tm"].named_parameters())
    assert set(params) == set(want)
    for name, p in params.items():
        w = want[name].numpy()
        got = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)


def test_frozen_parameters_get_no_gradient(tiny_pair):
    """The stem and layer1 (frozen_stages=1), and the LiDAR-side CNW
    weights, which C mode never reads; JAX gives them zeros."""
    want = jax_to_state_dict({"params": tiny_pair["jgrads"]})
    no_grad = {n for n, p in tiny_pair["tm"].named_parameters() if p.grad is None}
    frozen = {n for n, p in tiny_pair["tm"].named_parameters()
              if not p.requires_grad}
    assert frozen and all(n.startswith(("img_backbone.conv1.",
                                        "img_backbone.layer1.")) for n in frozen)
    assert no_grad == frozen | {
        "pts_bbox_head.transformer.img_channel_weights",
        "pts_bbox_head.transformer.pts_channel_weights"}
    for n in no_grad:
        assert not want[n].numpy().any(), n


def test_head_loss_matches_on_random_predictions(tiny_pair):
    """The loss alone, over two samples and two layers, with padded gts."""
    rng = np.random.RandomState(9)
    L, B, Q, G = 2, 2, 24, 6
    preds = dict(all_cls_scores=rng.randn(L, B, Q, 10).astype(np.float32),
                 all_bbox_preds=rng.randn(L, B, Q, 10).astype(np.float32))
    gt = rng.randn(B, G, 9).astype(np.float32) * 3
    gt[..., 3:6] = np.abs(gt[..., 3:6]) + 0.5
    batch = dict(gt_bboxes=gt, gt_labels=rng.randint(0, 10, (B, G)),
                 gt_valid=np.arange(G)[None, :] < np.array([[5], [2]]))
    want = tiny_pair["jm"].apply(tiny_pair["variables"], batch, preds,
                                 method=JaxUniBEV.loss)
    got = tiny_pair["tm"].loss({k: t(v) for k, v in batch.items()},
                               {k: t(v) for k, v in preds.items()})
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_train_mode_draws_from_the_generator():
    """GridMask and dropout: the same seed gives the same outputs, another
    seed others; without a generator a train-mode forward raises."""
    model = build_model(tiny_model_cfg(), "cpu", seed=0, train=True)
    batch = tiny_batch(np.random.RandomState(0))

    def run(seed):
        with torch.no_grad():
            out = model(batch, torch.Generator().manual_seed(seed))
        return out["all_cls_scores"]

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    with torch.no_grad():
        model.eval()
        d = model(batch)["all_cls_scores"]
        e = model(batch, torch.Generator().manual_seed(1))["all_cls_scores"]
        model.train()
    assert torch.equal(d, e) and not torch.allclose(a, d)
    with pytest.raises(RuntimeError, match="generator"):
        model(batch)


def test_train_step_moves_only_trainable_parameters():
    model = build_model(tiny_model_cfg(), "cpu", seed=0, train=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, sched = make_optimizer(model)
    metrics = train_step(model, opt, sched, tiny_batch(np.random.RandomState(0)),
                         torch.Generator().manual_seed(0))
    assert set(metrics) == {"loss_cls", "loss_bbox", "d0.loss_cls",
                            "d0.loss_bbox", "loss", "grad_norm", "sca_overflow",
                            "l_flag", "c_flag"}
    assert (float(metrics["l_flag"]), float(metrics["c_flag"])) == (0.0, 1.0)
    assert int(metrics["sca_overflow"]) == 0
    assert all(torch.isfinite(v) for v in metrics.values())
    np.testing.assert_allclose(
        float(metrics["loss"]),
        sum(float(v) for k, v in metrics.items() if k.endswith(("_cls", "_bbox"))),
        rtol=1e-6)
    for n, p in model.named_parameters():
        moved = not torch.equal(p, before[n])
        assert moved == p.requires_grad, n
    assert sched.get_last_lr()[-1] > opt.param_groups[-1]["initial_lr"] / 3
