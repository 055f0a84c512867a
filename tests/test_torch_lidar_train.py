"""Training the LC model: the LiDAR branch in train mode, modality dropout
and the LC train step, the port against the JAX package.

* ``MaskedBatchNorm``, ``SECOND`` and ``SECONDFPN`` in train mode against
  the JAX modules applied with ``train=True, mutable=["batch_stats"]``:
  outputs, gradients and the updated running statistics (flax updates the
  running variance with the biased batch variance; SECOND's second stage
  normalizes 4 values per channel here, where the unbiased one is 4/3
  larger);
* ``SparseEncoder`` in train mode (batch 2, capacities below the active
  sites): output, the gradient of every weight under a fixed cotangent,
  and all 21 updated BatchNorm statistics;
* the tiny LC model with train mode off and gradients on against
  ``jax.grad`` of the JAX ``train=False`` loss: every loss term and the
  gradient of every parameter (the JAX train-mode forward draws dropout at
  sites no config reaches, so whole-model parity runs in eval mode);
* modality dropout: the flag frequencies, their determinism, and the head
  under each forced pair of flags against the JAX head with the same flags
  (a dropped branch and both CNW weights get exactly zero gradient);
* ``train_step`` on the tiny LC model, and on a batch without images;
* ``val_step`` and the Runner's val-loss pass on the tiny LC model against
  the JAX ``make_val_step`` (one more jit, called on two batches).

Tolerances: module outputs 1e-4 relative to their scale; gradients 1e-3 of
each parameter's largest gradient (1e-4 for the single modules); running
statistics 1e-5 relative; flags and counts exactly; flag frequencies
within 5 sigma; val-step losses 1e-4 (PERF.md section 2).
"""

import functools
import logging
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from unibev_tpu.models.backbones.second import SECOND as JaxSECOND
from unibev_tpu.models.detectors.unibev import UniBEV as JaxUniBEV
from unibev_tpu.models.middle_encoder import MaskedBatchNorm as JaxMaskedBN
from unibev_tpu.models.middle_encoder import SparseEncoder as JaxSparseEncoder
from unibev_tpu.models.necks.fpn import SECONDFPN as JaxSECONDFPN
from unibev_tpu.parallel.train_state import make_val_step

from test_detector import tiny_batch as jax_tiny_batch
from test_sparse_conv import make_sparse
from torch_port_utils import perturb, port_state, t
from unibev_tpu_torch.flagship import build_model, tiny_batch, tiny_model_cfg
from unibev_tpu_torch.models.backbones.second import SECOND
from unibev_tpu_torch.models.middle_encoder import (MaskedBatchNorm,
                                                    SparseEncoder)
from unibev_tpu_torch.models.necks.fpn import SECONDFPN
from unibev_tpu_torch.models.transformer_fusion import sample_modality_flags
from unibev_tpu_torch.parallel.train_state import (make_optimizer, train_step,
                                                   val_step)
from unibev_tpu_torch.runtime.train_loop import Runner
from unibev_tpu_torch.utils.convert_jax import jax_to_state_dict

KEY = jax.random.PRNGKey(0)
LIDAR = ("pts_middle_encoder", "pts_backbone", "pts_neck")


def _close_scaled(got, want, rel=1e-4):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * scale, rtol=rel)


def _close_grads(got: dict, want: dict, rel):
    """Every gradient within ``rel`` of its parameter's largest one (a
    gradient that is exactly 0 in JAX must be exactly 0)."""
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        g = np.zeros_like(w) if got[name] is None else got[name].numpy()
        np.testing.assert_allclose(g, w, rtol=rel, atol=rel * np.abs(w).max(),
                                   err_msg=name)


def _close_stats(module: torch.nn.Module, want: dict):
    """The running statistics against the JAX ``batch_stats``, converted."""
    got = module.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    return len(keys)


def _jax_train_vjp(jm, variables, args, cot, **kw):
    """JAX train-mode apply: (outputs, parameter gradients under ``cot``,
    updated batch_stats)."""
    def f(params):
        out, state = jm.apply({**variables, "params": params}, *args,
                              train=True, mutable=["batch_stats"], **kw)
        return out, state["batch_stats"]

    @jax.jit
    def run(params, cot):
        out, vjp, stats = jax.vjp(f, params, has_aux=True)
        return out, vjp(cot)[0], stats
    return run(variables["params"], cot)


def _port_grads(module):
    return {n: p.grad for n, p in module.named_parameters()}


def _convert_grads(grads, path, prefix):
    """JAX parameter gradients (the parameters' tree) under port names."""
    return {k: v for k, v in port_state({"params": grads}, path, prefix).items()
            if not k.endswith("num_batches_tracked")}


def test_masked_batchnorm_train_matches_jax():
    rng = np.random.RandomState(0)
    V, C = 50, 8
    x = (rng.randn(V, C) * 2 + 1).astype(np.float32)
    mask = rng.rand(V) < 0.7
    cot = rng.randn(V, C).astype(np.float32)
    jm = JaxMaskedBN(C)
    variables = perturb(jm.init(KEY, jnp.asarray(x), jnp.asarray(mask)))

    def f(x, params):
        out, state = jm.apply({**variables, "params": params}, x,
                              jnp.asarray(mask), train=True,
                              mutable=["batch_stats"])
        return out, state["batch_stats"]
    want, vjp, stats = jax.vjp(f, jnp.asarray(x), variables["params"],
                               has_aux=True)
    want_dx, want_dp = vjp(jnp.asarray(cot))

    tm = MaskedBatchNorm(C)
    p, s = variables["params"], variables["batch_stats"]
    tm.load_state_dict(dict(weight=t(p["scale"]), bias=t(p["bias"]),
                            running_mean=t(s["mean"]), running_var=t(s["var"]),
                            num_batches_tracked=torch.tensor(0)))
    tm.train()
    xt = t(x).requires_grad_()
    out = tm(xt, t(mask))
    out.backward(t(cot))
    _close_scaled(out.detach().numpy(), want)
    assert bool((out[~t(mask)] == 0).all())
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               atol=1e-5, rtol=1e-4)
    _close_grads({"scale": tm.weight.grad, "bias": tm.bias.grad},
                 want_dp, 1e-4)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(stats[key]), rtol=1e-5, atol=1e-6)
    assert int(tm.num_batches_tracked) == 1


@pytest.mark.parametrize("which", ["SECOND", "SECONDFPN"])
def test_second_and_secondfpn_train_match_jax(which):
    """B=1: SECOND's second stage and SECONDFPN's second input are 2x2 maps,
    4 values per channel for each BatchNorm."""
    rng = np.random.RandomState(1)
    if which == "SECOND":
        xs = rng.randn(1, 4, 4, 32).astype(np.float32)
        cfg = dict(in_channels=32, out_channels=(32, 64), layer_nums=(1, 1),
                   layer_strides=(1, 2))
        jm, tm, path = JaxSECOND(**cfg), SECOND(**cfg), "pts_backbone"
        jargs, targs = (jnp.asarray(xs),), (t(xs).permute(0, 3, 1, 2),)
    else:
        xs = (rng.randn(1, 4, 4, 32).astype(np.float32),
              rng.randn(1, 2, 2, 64).astype(np.float32))
        cfg = dict(in_channels=(32, 64), out_channels=(16, 16),
                   upsample_strides=(1, 2))
        jm, tm, path = JaxSECONDFPN(**cfg), SECONDFPN(**cfg), "pts_neck"
        jargs = (tuple(jnp.asarray(x) for x in xs),)
        targs = (tuple(t(x).permute(0, 3, 1, 2) for x in xs),)
    variables = perturb(jm.init(KEY, *jargs))
    want_shapes = jax.eval_shape(lambda: jm.apply(variables, *jargs))
    cot = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.randn(*s.shape).astype(np.float32)),
        want_shapes)
    want, want_grads, stats = _jax_train_vjp(jm, variables, jargs, cot)

    tm.load_state_dict(port_state(variables, (path,), path + "."), strict=True)
    tm.train()
    got = tm(*targs)
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    sum((o * t(c).permute(0, 3, 1, 2)).sum() for o, c in zip(outs, cots)).backward()
    for o, w in zip(outs, wants):
        _close_scaled(o.detach().permute(0, 2, 3, 1).numpy(), w)
    _close_grads(_port_grads(tm),
                 _convert_grads(want_grads, (path,), path + "."), 1e-4)
    n = _close_stats(tm, port_state({**variables, "batch_stats": stats},
                                    (path,), path + "."))
    assert n == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in tm.modules())
    assert all(int(m.num_batches_tracked) == 1 for m in tm.modules()
               if isinstance(m, torch.nn.BatchNorm2d))


def test_sparse_encoder_train_matches_jax():
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
    cot = rng.randn(B, 4, 4, 16).astype(np.float32)
    want, want_grads, stats = _jax_train_vjp(jm, variables, args,
                                             jnp.asarray(cot), batch_size=B)

    path = ("pts_middle_encoder",)
    tm = SparseEncoder(**cfg)
    tm.load_state_dict(port_state(variables, path, path[0] + "."), strict=True)
    tm.train()
    bev, overflow = tm(t(feats), t(coords), t(mask), B)
    assert int(overflow[0]) > 0 and int(overflow[1]) > 0
    (bev.permute(0, 2, 3, 1) * t(cot)).sum().backward()
    _close_scaled(bev.detach().permute(0, 2, 3, 1).numpy(), want)
    _close_grads(_port_grads(tm),
                 _convert_grads(want_grads, path, path[0] + "."), 1e-4)
    assert _close_stats(tm, port_state({**variables, "batch_stats": stats},
                                       path, path[0] + ".")) == 2 * 21
    assert {int(m.num_batches_tracked) for m in tm.modules()
            if isinstance(m, MaskedBatchNorm)} == {1}


LC_KEYS = ("img", "points", "points_mask", "lidar2img", "gt_bboxes",
           "gt_labels", "gt_valid")
FLAG_PAIRS = [(1.0, 1.0), (1.0, 0.0), (0.0, 1.0)]       # (l_flag, c_flag)
IMG_BRANCH = ("pts_bbox_head.transformer.img_bev_encoder.",
              "pts_bbox_head.transformer.cams_embeds",
              "pts_bbox_head.transformer.img_level_embeds")
PTS_BRANCH = ("pts_bbox_head.transformer.pts_bev_encoder.",
              "pts_bbox_head.transformer.pts_level_embeds")
CNW = ("pts_bbox_head.transformer.img_channel_weights",
       "pts_bbox_head.transformer.pts_channel_weights")


@pytest.fixture(scope="module")
def lc_pair():
    """The tiny LC model in both packages (perturbed JAX variables carried
    over): the losses and gradients of the whole model in eval mode, and of
    the head alone on the JAX features under each pair of flags."""
    cfg = tiny_model_cfg(use_lidar=True)
    jbatch = jax_tiny_batch(np.random.RandomState(0))
    jbatch = {k: jbatch[k] for k in LC_KEYS}
    jm = JaxUniBEV(**cfg)
    variables = perturb(jax.jit(functools.partial(jm.init, train=False))(
        dict(params=KEY, gridmask=jax.random.PRNGKey(1)), jbatch), scale=0.01)

    def loss_fn(params):
        v = {**variables, "params": params}
        preds = jm.apply(v, jbatch, train=False)
        losses = jm.apply(v, jbatch, preds, method=JaxUniBEV.loss)
        return sum(losses.values()), losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])

    @jax.jit
    def features(v, b):
        img = jm.apply(v, b["img"], method=JaxUniBEV.extract_img_feat)
        pts = jm.apply(v, b["points"], b["points_mask"],
                       method=JaxUniBEV.extract_pts_feat)
        return img, pts

    def head_loss(params, img, pts, l_flag, c_flag):
        v = {**variables, "params": params}
        preds = jm.apply(v, img, pts, l_flag, c_flag, method=lambda m, *a: m.head(
            a[0], a[1], jbatch["lidar2img"], m.img_shape, a[2], a[3],
            deterministic=True))
        losses = jm.apply(v, jbatch, preds, method=JaxUniBEV.loss)
        return sum(losses.values()), preds

    head_vg = jax.jit(jax.value_and_grad(head_loss, has_aux=True))
    img_feats, pts_feats = features(variables, jbatch)
    jhead = {pair: head_vg(variables["params"], img_feats, pts_feats,
                           jnp.float32(pair[0]), jnp.float32(pair[1]))
             for pair in FLAG_PAIRS}

    tm = build_model(cfg, "cpu", seed=1, train=True)
    tm.load_state_dict(jax_to_state_dict(variables), strict=True)
    tm.eval()                    # no GridMask, no dropout; gradients stay on
    tbatch = {k: t(v) for k, v in jbatch.items()}
    tlosses = tm.loss(tbatch, tm(tbatch))
    sum(tlosses.values()).backward()
    tgrads = {n: None if p.grad is None else p.grad.clone()
              for n, p in tm.named_parameters()}

    thead = {}
    timg = [t(f) for f in img_feats]
    tpts = [t(f) for f in pts_feats]
    for l_flag, c_flag in FLAG_PAIRS:
        tm.zero_grad(set_to_none=True)
        preds = tm.pts_bbox_head(timg, tpts, tbatch["lidar2img"], tm.img_shape,
                                 torch.tensor(l_flag), torch.tensor(c_flag))
        sum(tm.loss(tbatch, preds).values()).backward()
        thead[l_flag, c_flag] = (
            {k: v.detach() for k, v in preds.items()},
            {n: None if p.grad is None else p.grad.clone()
             for n, p in tm.named_parameters() if n.startswith("pts_bbox_head.")})
    return dict(jlosses=jlosses, jgrads=jgrads, jhead=jhead,
                tlosses={k: v.detach() for k, v in tlosses.items()},
                tgrads=tgrads, thead=thead, jm=jm, variables=variables, tm=tm)


def test_lc_model_every_loss_term_matches(lc_pair):
    jl, tl = lc_pair["jlosses"], lc_pair["tlosses"]
    assert set(tl) == set(jl) == {"loss_cls", "loss_bbox", "d0.loss_cls",
                                  "d0.loss_bbox"}
    for k in jl:
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-5,
                                   err_msg=k)


def test_lc_model_every_gradient_matches(lc_pair):
    """Every parameter, the sparse-conv weights, the LiDAR BatchNorms and
    both CNW weights included."""
    want = jax_to_state_dict({"params": lc_pair["jgrads"]})
    got = lc_pair["tgrads"]
    assert {n for n in got if n.startswith(LIDAR)} and set(CNW) <= set(got)
    _close_grads(got, {n: want[n] for n in got}, 1e-3)
    for n in CNW + ("pts_middle_encoder.conv_input.0.weight",):
        assert got[n].abs().max() > 0, n


def test_modality_flags_frequencies():
    """dropout_prob 0.5, lidar_prob 0.5: LC 0.5, L 0.25, C 0.25, never
    neither."""
    gen = torch.Generator().manual_seed(0)
    n = 20000
    draws = torch.stack([torch.stack(sample_modality_flags(gen, 0.5, 0.5))
                         for _ in range(n)])
    assert draws.dtype == torch.float32 and set(draws.unique().tolist()) <= {0.0, 1.0}
    assert bool((draws.sum(1) > 0).all())
    for pair, p in (((1.0, 1.0), 0.5), ((1.0, 0.0), 0.25), ((0.0, 1.0), 0.25)):
        freq = float((draws == torch.tensor(pair)).all(1).float().mean())
        assert abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n), (pair, freq)


def test_modality_flags_follow_the_seed():
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        flags = [sample_modality_flags(gen, 0.5, 0.5) for _ in range(32)]
        for l_flag, c_flag in flags:
            assert l_flag.shape == c_flag.shape == ()
        return torch.tensor([[float(a), float(b)] for a, b in flags])
    assert torch.equal(draw(0), draw(0)) and not torch.equal(draw(0), draw(1))


@pytest.mark.parametrize("pair", FLAG_PAIRS, ids=["LC", "L", "C"])
def test_head_matches_jax_under_forced_flags(lc_pair, pair):
    (jloss, jpreds), jgrads = lc_pair["jhead"][pair]
    tpreds, tgrads = lc_pair["thead"][pair]
    for k in ("all_cls_scores", "all_bbox_preds", "bev_embed"):
        _close_scaled(tpreds[k].numpy(), jpreds[k])
    want = jax_to_state_dict({"params": jgrads})
    _close_grads(tgrads, {n: want[n] for n in tgrads}, 1e-3)


@pytest.mark.parametrize("pair", FLAG_PAIRS[1:], ids=["L", "C"])
def test_dropped_branch_gets_exactly_zero_gradient(lc_pair, pair):
    _, grads = lc_pair["thead"][pair]
    dropped = IMG_BRANCH if pair == (1.0, 0.0) else PTS_BRANCH
    kept = PTS_BRANCH if pair == (1.0, 0.0) else IMG_BRANCH
    names = [n for n in grads if n.startswith(dropped)]
    assert names and [n for n in grads if n.startswith(kept)]
    for n in names + list(CNW):
        assert grads[n] is None or not grads[n].any(), n
    assert any(grads[n] is not None and grads[n].any()
               for n in grads if n.startswith(kept))


def test_lc_train_step():
    """Two steps with modality dropout, then one on a batch without images:
    every trainable parameter moves, every LiDAR BatchNorm updates its
    running statistics once per step, and the flags come back."""
    model = build_model(tiny_model_cfg(use_lidar=True), "cpu", seed=0,
                        train=True)
    bns = {n: m for n, m in model.named_modules() if n.startswith(LIDAR)
           and isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
    assert len(bns) == 21 + 4 + 2
    stats = {n: m.running_mean.clone() for n, m in bns.items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, sched = make_optimizer(model)
    batch = tiny_batch(np.random.RandomState(0))
    gen = torch.Generator().manual_seed(0)
    flags = []
    for step in range(2):
        metrics = train_step(model, opt, sched, batch, gen)
        assert all(torch.isfinite(v) for v in metrics.values())
        assert int(metrics["sca_overflow"]) == 0
        flags.append((float(metrics["l_flag"]), float(metrics["c_flag"])))
        assert {int(m.num_batches_tracked) for m in bns.values()} == {step + 1}
    assert set(flags) <= set(FLAG_PAIRS)
    for n, p in model.named_parameters():
        assert (not torch.equal(p, before[n])) == p.requires_grad, n
    for n, m in bns.items():
        assert not torch.equal(m.running_mean, stats[n]), n

    l_batch = {k: v for k, v in batch.items() if k != "img"}
    metrics = train_step(model, opt, sched, l_batch, gen)
    assert (float(metrics["l_flag"]), float(metrics["c_flag"])) == (1.0, 0.0)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert {int(m.num_batches_tracked) for m in bns.values()} == {3}


@pytest.fixture
def one_thread():
    """The port's tiny forwards on one intra-op thread: beside the other
    test workers' processes, torch's thread pool waits on descheduled
    threads at every small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def val_pair(lc_pair):
    """JAX make_val_step's losses on two tiny LC batches (seeds 0 and 1; one
    jit) and the port's batches, as numpy samples without a batch axis."""
    step = make_val_step(lc_pair["jm"])

    @jax.jit
    def jval(v, b):
        return step(types.SimpleNamespace(**v), b)

    samples, losses = [], []
    for seed in (0, 1):
        b = jax_tiny_batch(np.random.RandomState(seed))
        b = {k: np.asarray(b[k]) for k in LC_KEYS}
        losses.append({k: float(v) for k, v in
                       jval(lc_pair["variables"], b).items()})
        samples.append({k: v[0] for k, v in b.items()})
    return samples, losses


def test_val_step_matches_jax(lc_pair, val_pair, one_thread):
    """The eval-mode losses and their sum under no_grad; the model's modes
    (here mixed) come back as they were and no gradient moves."""
    tm = lc_pair["tm"]
    tm.train()
    tm.pts_neck.eval()
    modes = {n: m.training for n, m in tm.named_modules()}
    grads = {n: None if p.grad is None else p.grad.clone()
             for n, p in tm.named_parameters()}
    for sample, want in zip(*val_pair):
        got = val_step(tm, {k: t(v)[None] for k, v in sample.items()})
        assert set(got) == set(want) and not got["loss"].requires_grad
        for k in want:
            np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    assert {n: m.training for n, m in tm.named_modules()} == modes
    for n, p in tm.named_parameters():
        assert (p.grad is None) == (grads[n] is None), n
        assert p.grad is None or torch.equal(p.grad, grads[n]), n
    tm.eval()


def test_val_loss_pass_matches_jax(lc_pair, val_pair, one_thread, tmp_path):
    """The Runner's val-loss pass (batches of one sample) against the mean
    of make_val_step's losses over the same samples."""
    samples, losses = val_pair
    runner = Runner(dict(workflow=[("train", 1), ("val", 1)]), samples,
                    str(tmp_path), logging.getLogger(__name__),
                    val_dataset=samples, device="cpu")
    assert runner.val_loss_epochs
    runner.model = lc_pair["tm"]
    got = runner._val_loss_pass()
    assert set(got) == set(losses[0])
    for k in got:
        np.testing.assert_allclose(got[k], np.mean([l[k] for l in losses]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
