"""Data parallel against one process, on the tiny LC model.

    python -m unibev_tpu_torch.tools.ddp_check [--device cpu|cuda]
        [--ranks 2] [--backend gloo|nccl]

Spawns ``--ranks`` ranks (``torch.multiprocessing``, joined over a
``FileStore`` in ``build/ddp_check``, one torch thread each): gloo ranks all on
``--device`` (gloo, unlike NCCL, puts several ranks on one card), or NCCL
ranks each on its own card (rank r on ``cuda:r``); and runs, in each, in
float32 (TF32 off):

1. the eval gather: ``make_eval_fn`` over 3 samples on the freshly built
   model (identical on every rank), each rank predicting its share; each
   sample's ground truth is the model's own 4 best boxes on it, so that
   the metric is far from 0 and a sample whose predictions were dropped or
   landed on another sample's ground truth would change it;
2. two train steps of the tiny LC model at B=1, rank r on sample r of a
   batch of N (the LiDAR modules in train mode, the rest in eval mode, so
   that nothing draws: batch statistics synchronized over the ranks, the
   losses' average factors global, DDP's mean gradient);
3. two train-mode steps with GridMask, dropout and modality dropout, the
   flags drawn from a generator seeded alike on every rank;

and writes what it saw (losses, gradients, LiDAR running statistics,
parameters and buffers, the flags, the metric) to the work dir.
:func:`one_process` runs 1 and 2 in this process at B=N on the same
device (its sparse capacities N times the ranks': they are per forward,
so N ranks hold N times one forward's), and :func:`compare` holds the
ranks against it: both steps' losses and running statistics and the first
step's gradients within :data:`REL` (AdamW's first update is about lr x
sign(gradient), so where a gradient is within rounding of 0 the two runs'
parameters part by up to 2 lr, which the second step's gradients show),
every rank's parameters and buffers bit-identical, every rank's flags the
same, and the gathered metric equal to the one process's.  The tiny batch
has 256 points a sample, which overflow no capacity of a rank's forward.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import os.path as osp
import shutil
import sys
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from unibev_tpu_torch.flagship import build_model, tiny_batch, tiny_model_cfg
from unibev_tpu_torch.parallel.dist import process_allgather
from unibev_tpu_torch.parallel.train_state import (data_parallel, eval_mode,
                                                   make_optimizer, train_step)
from unibev_tpu_torch.runtime.eval_hook import make_eval_fn

LIDAR_MODULES = ("pts_middle_encoder", "pts_backbone", "pts_neck")
POINTS = 256            # a sample's points: no sparse capacity overflows at B=2
STEPS = 2
EVAL_SAMPLES = 3
REL = 1e-3              # relative to each tensor's largest magnitude


def spawn_ranks(fn: Callable, world: int, work_dir: str, *args,
                backend: str = "gloo") -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in one ``backend`` group over a ``FileStore`` in ``work_dir`` (NCCL:
    rank r's current device is ``cuda:r``); raises if a rank fails.  ``fn``
    must be importable (a module-level function)."""
    os.makedirs(work_dir, exist_ok=True)
    store = osp.join(work_dir, "store")
    if osp.exists(store):
        os.remove(store)
    torch.multiprocessing.spawn(
        _rank_entry, args=(fn, world, store, backend, args), nprocs=world,
        join=True)


def _rank_entry(rank, fn, world, store, backend, args):
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def _model(device, capacity_scale: int = 1):
    """The tiny LC model built for training, its sparse capacities times
    ``capacity_scale``, in the mode that draws nothing: eval, with the LiDAR
    modules in train mode."""
    cfg = tiny_model_cfg(use_lidar=True)
    me = cfg["pts_middle_encoder"]
    me["capacities"] = tuple(c * capacity_scale for c in me["capacities"])
    model = build_model(cfg, device, seed=0, train=True).eval()
    for name in LIDAR_MODULES:
        getattr(model, name).train()
    return model


def _batch(world, device):
    return tiny_batch(np.random.RandomState(0), B=world, P=POINTS,
                      device=device)


def _samples(model, device, n=EVAL_SAMPLES):
    """Eval samples as a dataset: numpy sample dicts (no batch axis), the
    first 4 ground-truth boxes of each the model's 4 best predictions."""
    out = []
    for seed in range(n):
        b = tiny_batch(np.random.RandomState(seed), P=POINTS, device=device)
        with eval_mode(model):
            pred = model.predict(b)
        best = pred["scores"][0].argsort(descending=True)[:4]
        b["gt_bboxes"][0, :4] = pred["bboxes"][0, best]
        b["gt_labels"][0, :4] = pred["labels"][0, best]
        out.append({k: v[0].cpu().numpy() for k, v in b.items()})
    return out


def _same_metric(a: Dict, b: Dict, tol: float = 1e-6) -> bool:
    """The same keys and values within ``tol`` (NaN equal to NaN): on the
    card the voxel means sum with float atomics, in no fixed order."""
    return set(a) == set(b) and all(
        abs(a[k] - b[k]) <= tol or (a[k] != a[k] and b[k] != b[k]) for k in a)


def _running_stats(model):
    return {n: b.detach().cpu().clone() for n, b in model.named_buffers()
            if n.startswith(LIDAR_MODULES)
            and n.endswith(("running_mean", "running_var"))}


def _steps(net, model, batch, device, flags=False) -> List[Dict]:
    opt, sched = make_optimizer(model)
    out = []
    gen = flag_gen = None
    if flags:
        rank = dist.get_rank() if dist.is_initialized() else 0
        model.train()
        gen = torch.Generator(device=device).manual_seed(7 + rank)
        flag_gen = torch.Generator(device=device).manual_seed(6)
    for _ in range(STEPS):
        m = train_step(net, opt, sched, batch, gen, flag_generator=flag_gen)
        rec = dict(metrics={k: float(v) for k, v in m.items()})
        if not flags:
            rec.update(grads={n: p.grad.detach().cpu().clone()
                              for n, p in model.named_parameters()
                              if p.grad is not None},
                       stats=_running_stats(model))
        out.append(rec)
    return out


@contextlib.contextmanager
def _float32():
    """TF32 off for matmuls and cuDNN (its convolutions default to TF32):
    the ranks and the one process compare in float32; the flags come back
    as they were."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def rank_main(rank: int, world: int, device: str, work_dir: str) -> None:
    """One rank's work (see the module docstring), saved to
    ``work_dir/rank{rank}.pt``."""
    with _float32():
        _rank_main(rank, world, device, work_dir)


def _rank_main(rank, world, device, work_dir):
    if dist.get_backend() == "nccl":
        device = f"cuda:{rank}"
    model = _model(device)
    metric = make_eval_fn()(model, _samples(model, device))
    net = data_parallel(model, device)
    batch = {k: v[rank:rank + 1] for k, v in _batch(world, device).items()}
    steps = _steps(net, model, batch, device)
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    flags = [(s["metrics"]["l_flag"], s["metrics"]["c_flag"])
             for s in _steps(net, model, batch, device, flags=True)]
    # the host gather itself: each rank's rank, and a dict of arrays
    gathered = process_allgather(dict(rank=np.asarray([rank], np.int32),
                                      ones=np.ones((2, 3), bool)))
    torch.save(dict(metric=metric, steps=steps, state=state, flags=flags,
                    gathered=gathered), osp.join(work_dir, f"rank{rank}.pt"))


def run_ranks(world: int, device: str, work_dir: str,
              backend: str = "gloo") -> List[Dict]:
    """Spawn the ranks and return what each saw."""
    spawn_ranks(rank_main, world, work_dir, device, work_dir,
                backend=backend)
    return [torch.load(osp.join(work_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def one_process(world: int, device: str) -> Dict:
    """The eval metric over the same samples and the two steps at B=world in
    this process."""
    with _float32():
        model = _model(device)
        metric = make_eval_fn()(model, _samples(model, device))
        model = _model(device, capacity_scale=world)
        steps = _steps(model, model, _batch(world, device), device)
    return dict(metric=metric, steps=steps)


def _worst(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
           what: str) -> float:
    """The worst error of ``got`` against ``want``, relative to each
    tensor's largest magnitude; raises above :data:`REL`."""
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:5])
    worst = 0.0
    for n, w in want.items():
        err = (got[n].float() - w.float()).abs().max().item()
        scale = max(w.float().abs().max().item(), 1e-12)
        if not err <= REL * scale:
            raise AssertionError(f"{what} {n}: {err} > {REL} x {scale}")
        worst = max(worst, err / scale)
    return worst


def compare(ranks: List[Dict], ref: Dict) -> Dict:
    """Hold the ranks against the one process (see the module docstring);
    returns the worst relative errors."""
    out = dict(losses=0.0, grads=0.0, stats=0.0)
    for step, want in enumerate(ref["steps"]):
        got = ranks[0]["steps"][step]
        losses = {k: torch.tensor(v) for k, v in want["metrics"].items()
                  if "loss" in k}
        out["losses"] = max(out["losses"], _worst(
            {k: torch.tensor(got["metrics"][k]) for k in losses}, losses,
            f"step {step} loss"))
        if step == 0:
            out["grads"] = _worst(got["grads"], want["grads"],
                                  "step 0 gradient")
        out["stats"] = max(out["stats"], _worst(got["stats"], want["stats"],
                                                f"step {step} stats"))
        if not want["stats"]:
            raise AssertionError("no LiDAR running statistic")
    for r in ranks[1:]:
        for k, v in ranks[0]["state"].items():
            if not torch.equal(r["state"][k], v):
                raise AssertionError(f"{k} differs between ranks")
        if r["flags"] != ranks[0]["flags"]:
            raise AssertionError(f"flags differ: {r['flags']} vs "
                                 f"{ranks[0]['flags']}")
    for r in ranks:
        if not _same_metric(r["metric"], ref["metric"]):
            raise AssertionError(f"gathered metric {r['metric']} != one "
                                 f"process's {ref['metric']}")
        g = r["gathered"]
        if g["rank"].ravel().tolist() != list(range(len(ranks))):
            raise AssertionError(f"process_allgather gave {g}")
    if not ref["metric"]["mAP"] > 0:
        raise AssertionError(f"a degenerate metric: {ref['metric']}")
    out.update(state_tensors=len(ranks[0]["state"]),
               flags=ranks[0]["flags"], metric=ranks[0]["metric"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    args = p.parse_args(argv)
    work_dir = osp.join("build", "ddp_check")
    shutil.rmtree(work_dir, ignore_errors=True)
    ranks = run_ranks(args.ranks, args.device, work_dir, args.backend)
    result = compare(ranks, one_process(args.ranks, args.device))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
