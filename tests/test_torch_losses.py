"""The port's training pieces outside the model against the JAX package's.

Losses (focal, L1 and their weighted / averaged wrappers), ``normalize_bbox``,
the two match costs, the Hungarian assigner's ``(gt_inds, pos_mask)``,
GridMask fed the JAX draws, the learning-rate schedule and one AdamW step
from the same gradients against ``make_optimizer``'s ``tx.update``.

Inputs come from numpy seeds.  The assigner's costs are continuous random
values, so every optimum is unique and scipy (the port) and the in-graph
Jonker-Volgenant (the JAX package) must agree exactly.

Tolerances: float32 elementwise math, rtol 1e-5 / atol 1e-6; the optimizer
step atol 1e-6 (torch clips by max_norm / (norm + 1e-6), optax by
max_norm / norm: a relative 3e-8 here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from unibev_tpu.core.bbox.assigners import HungarianAssigner3D as JaxAssigner
from unibev_tpu.core.bbox.match_costs import BBox3DL1Cost as JaxL1Cost
from unibev_tpu.core.bbox.match_costs import FocalLossCost as JaxFocalCost
from unibev_tpu.core.bbox.util import normalize_bbox as jax_normalize_bbox
from unibev_tpu.models.gridmask import grid_mask as jax_grid_mask
from unibev_tpu.ops import losses as jax_losses
from unibev_tpu.parallel.train_state import make_optimizer as jax_make_optimizer
from unibev_tpu.runtime.lr_schedule import \
    cosine_with_linear_warmup as jax_schedule

from torch_port_utils import t
from unibev_tpu_torch.core.bbox.assigners import HungarianAssigner3D
from unibev_tpu_torch.core.bbox.match_costs import BBox3DL1Cost, FocalLossCost
from unibev_tpu_torch.core.bbox.util import normalize_bbox
from unibev_tpu_torch.models.gridmask import grid_mask_from_draws
from unibev_tpu_torch.ops.losses import (FocalLoss, L1Loss, l1_loss,
                                         sigmoid_focal_loss)
from unibev_tpu_torch.parallel.train_state import GRAD_CLIP, make_optimizer
from unibev_tpu_torch.runtime.lr_schedule import cosine_with_linear_warmup

TOL = dict(rtol=1e-5, atol=1e-6)


def _logits_labels(seed, shape=(3, 17), num_classes=10):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape, num_classes) * 3).astype(np.float32)
    labels = rng.randint(0, num_classes + 1, shape)   # num_classes = background
    return logits, labels


def test_sigmoid_focal_loss_and_its_gradient():
    logits, labels = _logits_labels(0)
    want, vjp = jax.vjp(lambda x: jax_losses.sigmoid_focal_loss(
        x, jnp.asarray(labels), 10, alpha=0.25, gamma=2.0), jnp.asarray(logits))
    x = t(logits).requires_grad_()
    got = sigmoid_focal_loss(x, t(labels), 10, alpha=0.25, gamma=2.0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    g = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    (grad,) = torch.autograd.grad(got, x, t(g))
    np.testing.assert_allclose(grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               **TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_focal_and_l1_loss_wrappers(weighted):
    logits, labels = _logits_labels(2)
    rng = np.random.RandomState(3)
    pred, target = rng.randn(2, 3, 10).astype(np.float32), rng.randn(2, 3, 10)
    target = target.astype(np.float32)
    w_cls = rng.rand(3, 17).astype(np.float32) if weighted else None
    w_reg = rng.rand(2, 3, 10).astype(np.float32) if weighted else None
    avg = 7.0 if weighted else None

    def j(a):
        return None if a is None else jnp.asarray(a)

    def p(a):
        return None if a is None else t(a)

    want = jax_losses.FocalLoss(loss_weight=2.0)(
        jnp.asarray(logits), jnp.asarray(labels), j(w_cls), avg)
    got = FocalLoss(loss_weight=2.0)(t(logits), t(labels), p(w_cls), avg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want = jax_losses.L1Loss(loss_weight=0.25)(jnp.asarray(pred),
                                               jnp.asarray(target), j(w_reg), avg)
    got = L1Loss(loss_weight=0.25)(t(pred), t(target), p(w_reg), avg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_array_equal(l1_loss(t(pred), t(target)).numpy(),
                                  np.asarray(jax_losses.l1_loss(pred, target)))


@pytest.mark.parametrize("dims", [7, 9])
def test_normalize_bbox(dims):
    rng = np.random.RandomState(4)
    boxes = rng.randn(5, 8, dims).astype(np.float32) * 3
    boxes[0, :, 3:6] = 0.0                     # sizes below the 1e-5 clip
    want = np.asarray(jax_normalize_bbox(jnp.asarray(boxes)))
    got = normalize_bbox(t(boxes)).numpy()
    assert got.shape == (5, 8, dims + 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_match_costs():
    logits, _ = _logits_labels(5, shape=(30,))
    rng = np.random.RandomState(6)
    gt_labels = rng.randint(0, 10, 12)
    pred = rng.randn(30, 8).astype(np.float32)
    gt = rng.randn(12, 8).astype(np.float32)
    want = JaxFocalCost(weight=2.0)(jnp.asarray(logits), jnp.asarray(gt_labels))
    got = FocalLossCost(weight=2.0)(t(logits), t(gt_labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = JaxL1Cost(weight=0.25)(jnp.asarray(pred), jnp.asarray(gt))
    got = BBox3DL1Cost(weight=0.25)(t(pred), t(gt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_assigner_matches_jax_exactly():
    rng = np.random.RandomState(7)
    n, Q, G = 4, 24, 6
    bbox_pred = rng.randn(n, Q, 10).astype(np.float32)
    cls_pred = rng.randn(n, Q, 10).astype(np.float32)
    gt = rng.randn(n, G, 9).astype(np.float32)
    gt[..., 3:6] = np.abs(gt[..., 3:6]) + 0.5
    labels = rng.randint(0, 10, (n, G))
    valid = np.arange(G)[None, :] < np.array([6, 4, 1, 0])[:, None]  # packed
    cfg = dict(cls_cost=dict(type="FocalLossCost", weight=2.0),
               reg_cost=dict(type="BBox3DL1CostBEVFormer", weight=0.25))
    res = jax.vmap(JaxAssigner(**cfg).assign)(*map(jnp.asarray, (
        bbox_pred, cls_pred, gt, labels, valid)))
    gt_inds, pos = HungarianAssigner3D(**cfg).assign(
        t(bbox_pred), t(cls_pred), t(gt), t(labels), t(valid))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(res.pos_mask))
    np.testing.assert_array_equal(gt_inds.numpy(), np.asarray(res.gt_inds))
    assert pos.sum(-1).tolist() == [6, 4, 1, 0]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_grid_mask_from_the_jax_draws(seed):
    """Same draws as unibev_tpu/models/gridmask.py; seeds cover applied and
    not applied."""
    H, W = 40, 56
    x = np.random.RandomState(seed).randn(3, H, W, 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_grid_mask(jnp.asarray(x), key))
    k_apply, k_d, k_sh, k_sw = jax.random.split(key, 4)
    draws = (bool(jax.random.uniform(k_apply) < 0.7),
             int(jax.random.randint(k_d, (), 2, H)),
             int(jax.random.randint(k_sh, (), 0, H)),
             int(jax.random.randint(k_sw, (), 0, W)))
    got = grid_mask_from_draws(t(x).permute(0, 3, 1, 2), *draws)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_lr_schedule():
    want = jax_schedule(2e-4, 1000, 100, 1 / 3, 1e-3)
    got = cosine_with_linear_warmup(2e-4, 1000, 100, 1 / 3, 1e-3)
    for step in (0, 1, 50, 99, 100, 101, 400, 999, 1000, 1200):
        # the JAX schedule computes in float32
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5)


class _Named(torch.nn.Module):
    """Parameters under given state_dict names."""

    def __init__(self, names, shapes):
        super().__init__()
        self.names = list(names)
        self.p = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.zeros(s)) for s in shapes])

    def named_parameters(self, *args, **kwargs):
        yield from zip(self.names, self.p)


def test_adamw_step_matches_optax():
    """Two steps (warm-up lr, bias correction, clipping at a global norm
    above 35) from the same gradients and weights."""
    # JAX path -> (port name, shape), one per lr rule
    names = {"img_backbone/conv1/kernel": ("img_backbone.conv1.weight", (4, 3)),
             "img_backbone/layer1_0/conv1/kernel":
                 ("img_backbone.layer1.0.conv1.weight", (5,)),
             "img_backbone/layer3_0/conv2/weight":
                 ("img_backbone.layer3.0.conv2.weight", (3, 3)),
             "pts_bbox_head/bev_embedding":
                 ("pts_bbox_head.bev_embedding.weight", (6, 2)),
             "pts_bbox_head/reg_branch0/out/bias":
                 ("pts_bbox_head.reg_branches.0.4.bias", (7,))}
    shapes = {k: s for k, (_, s) in names.items()}
    rng = np.random.RandomState(8)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 20).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]

    def tree(flat):
        out = {}
        for path, v in flat.items():
            node = out
            *parents, leaf = path.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(v)
        return out

    tx, _ = jax_make_optimizer()
    jp = tree(params)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(tree(g), state, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, updates)

    model = _Named([n for n, _ in names.values()], shapes.values())
    with torch.no_grad():
        for p, v in zip(model.p, params.values()):
            p.copy_(t(v))
    opt, sched = make_optimizer(model)
    assert sorted(g["lr_mult"] for g in opt.param_groups) == [0.0, 0.1, 1.0]
    for g in grads:
        for p, v in zip(model.p, g.values()):
            p.grad = t(v)
        norm = torch.nn.utils.clip_grad_norm_(list(model.p), GRAD_CLIP)
        assert float(norm) > GRAD_CLIP
        opt.step()
        sched.step()
    for (path, _), p in zip(shapes.items(), model.p):
        node = jp
        for k in path.split("/"):
            node = node[k]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(node),
                                   atol=1e-6, rtol=0, err_msg=path)
    for frozen in (0, 1):                      # lr 0: bit-identical
        np.testing.assert_array_equal(model.p[frozen].detach().numpy(),
                                      list(params.values())[frozen])
