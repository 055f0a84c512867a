"""A training cell: the port's ``parallel.train_state.train_step`` with the
configuration's AdamW, clipping and schedule, and its check.

Set-up builds one training object (float32 parameters from the seed, the
optimizer, the generators of GridMask, dropout and modality dropout) and
drives it through its first ``compare_steps`` steps with the window's own
call, on distinct batches of the pool; it keeps what those steps show: each
step's loss, each parameter's gradient norm as the optimizer got it after
step 1 (its first moment over 1 - beta1) and each parameter's change over
the steps.  The window then goes on training that same object.  After the
window the reference (float32, TF32 off, its own frozen train step and
optimizer) takes the same steps from the same seed, the same batches and
the same generator states, and the numbers compared are:

* ``loss1``, ``loss2``, ...: each step's relative gap of the loss;
* ``grad_median``: the median over parameters of the gap between the two
  gradient norms, against the reference's norm of that parameter or the
  median parameter's, whichever is larger (some gradients are all but
  zero);
* ``update_median``: the same for the norm of each parameter's change over
  the steps, leaving out the parameters whose reference gradient is under
  a thousandth of the median one's (those move by rounding alone: a
  modality the step dropped).  A step that leaves the state unchanged
  reads 1;
* ``counts``: the largest difference of each step's forward counts (the
  voxels of each sample before the cap, the sparse convs' overflow, which
  the per-forward capacities make depend on every sample of the batch),
  exact.

The median and not the worst parameter: the worst reads 0.35-1.26 for
the gradient (the reference points' 3-wide bias, then the box branches:
their gradients sum L1 signs, bilinear weights that jump at cell edges and
the assignment, which rounding flips) and 0.13-0.16 for the change (the
decoder's packed query / key / value bias, whose key third is under
softmax and moves by round-off alone) on every seed of the bf16 port, the
fp8 control and a half batch alike.  ``worst_leaves`` names them in every
run's log.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch


# the forward's counts, compared exactly: the LiDAR branch's voxels a sample
# before the cap and the sparse convs' overflow
COUNTS = ("num_distinct_voxels", "sparse_overflow")


def optimizer_args(config_file: str) -> Dict:
    """The optimizer settings of a config file, read as the port's training
    runner reads them; the schedule's length is the port's default (the
    steps compared lie in its linear warm-up, which the length leaves
    alone)."""
    from benchmark.reference.config.config import Config
    cfg = Config.fromfile(config_file)
    opt = dict(cfg.get("optimizer", {}) or {})
    lr = dict(cfg.get("lr_config", {}) or {})
    clip = dict(cfg.get("optimizer_config", {}) or {}).get(
        "grad_clip", {}) or {}
    return dict(base_lr=opt.get("lr", 2e-4),
                weight_decay=opt.get("weight_decay", 0.01),
                warmup_iters=lr.get("warmup_iters", 500),
                warmup_ratio=lr.get("warmup_ratio", 1.0 / 3),
                min_lr_ratio=lr.get("min_lr_ratio", 1e-3),
                grad_clip=clip.get("max_norm", 35.0))


def _generators(seed: int, device):
    """(GridMask and dropout, modality flags) generators from ``seed``."""
    return (torch.Generator(device=device).manual_seed((3 * seed + 7) % 2 ** 63),
            torch.Generator(device=device).manual_seed((3 * seed + 6) % 2 ** 63))


def _norms(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.float().norm() for t in tensors]).cpu()


def take_steps(step: Callable, model, opt, pool, steps: int, p0) -> Dict:
    """Run ``steps`` steps of ``step`` on pool batches 0 .. steps - 1;
    return the losses, the gradient norms after step 1 and the change
    norms after the last step, per parameter in ``model``'s order."""
    params = [p for p in model.parameters() if p.requires_grad]
    beta1 = opt.param_groups[0]["betas"][0]
    losses, grads, counts = [], None, []
    hook = model.register_forward_hook(
        lambda m, args, out: counts.append(
            [out[k].detach().to("cpu", torch.int64).reshape(-1)
             for k in COUNTS if k in out]))
    for k in range(steps):
        out = step(pool[k % len(pool)])
        losses.append(float(out["loss"]))
        if k == 0:
            grads = _norms([opt.state[p]["exp_avg"] / (1 - beta1)
                            if p in opt.state else torch.zeros(())
                            for p in params])
    hook.remove()
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    change = _norms([p.detach() - p0[n] for n, p in zip(names, params)])
    return dict(loss=torch.tensor(losses), grad=grads, update=change,
                names=names, counts=counts)


def build(model, config_file: str, seed: int, device, train_state):
    """(step(batch) -> metrics, optimizer) of ``model`` with the config's
    optimizer and generators drawn from ``seed``, through the given
    ``train_state`` module (the port's or the reference's)."""
    opt, sched = train_state.make_optimizer(model, **optimizer_args(config_file))
    gen, flags = _generators(seed, device)

    def step(batch):
        return train_state.train_step(model, opt, sched, batch, gen,
                                      flag_generator=flags)
    return step, opt


def _gaps(got: Dict, want: Dict, key: str, keep=None) -> torch.Tensor:
    """Each parameter's gap between the two norms of ``key``, against the
    larger of the reference's norm and the median parameter's."""
    r, g = want[key], got[key]
    if keep is not None:
        r, g = r[keep], g[keep]
    return (g - r).abs() / torch.maximum(r, r.median().clamp(min=1e-30))


def compare(got: Dict, want: Dict) -> Dict[str, float]:
    """The numbers of one run: see the module's docstring."""
    if got["names"] != want["names"]:
        raise ValueError("the port and the reference train other parameters")
    loss = ((got["loss"] - want["loss"]).abs()
            / want["loss"].abs().clamp(min=1e-30)).tolist()
    g_ref = want["grad"]
    keep = g_ref >= 1e-3 * g_ref.median()
    out = {f"loss{k + 1}": v for k, v in enumerate(loss)}
    out["counts"] = max((float((a - b).abs().max()) if a.shape == b.shape
                         else float("inf")
                         for g, w in zip(got["counts"], want["counts"])
                         for a, b in zip(g, w)), default=0.0)
    if len(got["counts"]) != len(want["counts"]):
        out["counts"] = float("inf")
    out.update(grad_median=float(_gaps(got, want, "grad").median()),
               update_median=float(_gaps(got, want, "update", keep).median()))
    return out


def worst_leaves(got: Dict, want: Dict, n: int = 4) -> Dict[str, list]:
    """The ``n`` parameters of each number's largest gaps, with both norms:
    what a look at a reading starts from."""
    out = {}
    for key in ("grad", "update"):
        r, g = want[key], got[key]
        gap = _gaps(got, want, key)
        order = torch.argsort(gap, descending=True)[:n]
        out[key] = [(got["names"][i], float(gap[i]), float(g[i]), float(r[i]))
                    for i in order.tolist()]
    return out


def reference_readings(cls, config_file: str, state: Dict, seed: int, pool,
                       steps: int, device, control: bool = False) -> Dict:
    """The reference's readings (the detector file's reference class
    ``cls``) over the same steps (``control``: the reference in fp8, its
    weights rounded before each step)."""
    from benchmark.reference import build as ref_build, precision
    from benchmark.reference.parallel import train_state
    ref = ref_build.build(cls, config_file, state, device).requires_grad_(
        True).train()
    step, opt = build(ref, config_file, seed, device, train_state)
    if control:
        inner = step

        def step(batch):
            with torch.no_grad():
                for p in ref.parameters():
                    p.copy_(precision.round_fp8(p))
            with precision.fp8(ref):
                return inner(batch)
    p0 = {k: v.float() for k, v in state.items()}
    return take_steps(step, ref, opt, pool, steps, p0)
