"""Data parallel, the port against the JAX package and against itself.

* ``shard_indices`` at world size 2, each rank's share against the JAX
  function with its ``jax.process_count`` / ``process_index`` patched;
* two gloo ranks at batch 1 (spawned over a ``FileStore``, one torch
  thread each) against the JAX modules in train mode at batch 2:
  ``BatchNorm2d`` (flax's ``BatchNorm``), ``MaskedBatchNorm`` and
  ``SECOND``: outputs, the updated running statistics on every rank, the
  parameter gradients (summed over the ranks) and the input gradient;
* ``unibev_tpu_torch/tools/ddp_check.py``: two ranks of the tiny LC model
  at batch 1 against one process at batch 2 (two train steps: losses,
  gradients, LiDAR running statistics; parameters and buffers bit-identical
  across the ranks; the modality flags equal across the ranks in train
  mode), the eval gather of 3 samples against the one process's metric,
  and ``process_allgather``;
* the train CLI under ``torch.distributed.run --nproc_per_node=2 --device
  cpu`` on the fake nuScenes tree, and the test CLI under the same launcher
  on its checkpoint against one process's results.

The tiny LC model's losses and gradients at 2 x batch 1 against the JAX
package run in tests/test_torch_lidar_train.py, beside its JAX model.

Tolerances: module outputs and running statistics 1e-5 relative to their
scale, gradients 1e-4 (PERF.md section 2); the ranks against one process
1e-3 relative to each tensor's largest (``ddp_check``), losses 1e-5; the
CLI's gathered results exactly.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as flax_nn
from unibev_tpu.models.backbones.second import SECOND as JaxSECOND
from unibev_tpu.models.middle_encoder import MaskedBatchNorm as JaxMaskedBN
from unibev_tpu.parallel import dist as jax_dist

from test_torch_lidar_train import _jax_train_vjp
from torch_port_utils import fake_nuscenes_tree, perturb, port_state, t
from unibev_tpu_torch.parallel import dist
from unibev_tpu_torch.tools import ddp_check, test_UniBEV
from unibev_tpu_torch.tools.ddp_check import spawn_ranks

import torch_dist_workers

KEY = jax.random.PRNGKey(0)
REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("n,shuffle", [(10, True), (7, True), (7, False),
                                       (1, False)])
def test_shard_indices_match_jax_at_world_two(monkeypatch, n, shuffle,
                                              drop_last):
    shares = []
    for rank in range(2):
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(dist, "get_world_size", lambda: 2)
        monkeypatch.setattr(dist, "get_rank", lambda r=rank: r)
        got = dist.shard_indices(n, shuffle=shuffle, seed=3,
                                 drop_last=drop_last)
        want = jax_dist.shard_indices(n, shuffle=shuffle, seed=3,
                                      drop_last=drop_last)
        np.testing.assert_array_equal(got, want)
        shares.append(got)
    if n > 1:
        assert len(shares[0]) == len(shares[1])
    if not drop_last and n > 1:
        assert set(np.concatenate(shares)) == set(range(n))


def test_helpers_are_the_identity_without_a_group():
    assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
    assert not dist.is_distributed()
    x = {"a": np.arange(3)}
    assert dist.process_allgather(x) is x
    y = torch.ones(2, requires_grad=True)
    assert dist.sum_over_ranks(y) is y
    assert dist.init_dist("cpu") == torch.device("cpu")   # no launcher


def _bn_cases(rng):
    """The JAX modules in train mode at batch 2 and the port's inputs, one
    half per rank."""
    cases, want = {}, {}
    # flax BatchNorm as SECOND / SECONDFPN build it
    x = (rng.randn(2, 3, 3, 8) * 2 + 1).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    jm = flax_nn.BatchNorm(use_running_average=False, momentum=0.99,
                           epsilon=1e-3)
    v = perturb(jm.init(KEY, jnp.asarray(x)))

    def f(x, params):
        out, st = jm.apply({**v, "params": params}, x, mutable=["batch_stats"])
        return out, st["batch_stats"]
    out, vjp, stats = jax.vjp(f, jnp.asarray(x), v["params"], has_aux=True)
    dx, dp = vjp(jnp.asarray(cot))
    cases["BatchNorm2d"] = dict(
        kind="BatchNorm2d", cfg=dict(num_features=8, eps=1e-3, momentum=0.01),
        state=dict(weight=t(v["params"]["scale"]), bias=t(v["params"]["bias"]),
                   running_mean=t(v["batch_stats"]["mean"]),
                   running_var=t(v["batch_stats"]["var"]),
                   num_batches_tracked=torch.tensor(0)),
        x=[t(x[r:r + 1]).permute(0, 3, 1, 2) for r in range(2)],
        cot=[(t(cot[r:r + 1]).permute(0, 3, 1, 2),) for r in range(2)])
    want["BatchNorm2d"] = dict(
        out=[np.asarray(out).transpose(0, 3, 1, 2)],
        dx=np.asarray(dx).transpose(0, 3, 1, 2),
        grads=dict(weight=dp["scale"], bias=dp["bias"]),
        buffers=dict(running_mean=stats["mean"], running_var=stats["var"]))

    # MaskedBatchNorm over two samples' voxel rows
    V, C = 30, 8
    x = (rng.randn(2 * V, C) * 2 + 1).astype(np.float32)
    mask = rng.rand(2 * V) < 0.7
    cot = rng.randn(2 * V, C).astype(np.float32)
    jm = JaxMaskedBN(C)
    v = perturb(jm.init(KEY, jnp.asarray(x), jnp.asarray(mask)))

    def g(x, params):
        out, st = jm.apply({**v, "params": params}, x, jnp.asarray(mask),
                           train=True, mutable=["batch_stats"])
        return out, st["batch_stats"]
    out, vjp, stats = jax.vjp(g, jnp.asarray(x), v["params"], has_aux=True)
    dx, dp = vjp(jnp.asarray(cot))
    cases["MaskedBatchNorm"] = dict(
        kind="MaskedBatchNorm", cfg=dict(features=C),
        state=dict(weight=t(v["params"]["scale"]), bias=t(v["params"]["bias"]),
                   running_mean=t(v["batch_stats"]["mean"]),
                   running_var=t(v["batch_stats"]["var"]),
                   num_batches_tracked=torch.tensor(0)),
        x=[t(x[r * V:(r + 1) * V]) for r in range(2)],
        mask=[t(mask[r * V:(r + 1) * V]) for r in range(2)],
        cot=[(t(cot[r * V:(r + 1) * V]),) for r in range(2)])
    want["MaskedBatchNorm"] = dict(
        out=[np.asarray(out)], dx=np.asarray(dx),
        grads=dict(weight=dp["scale"], bias=dp["bias"]),
        buffers=dict(running_mean=stats["mean"], running_var=stats["var"]))

    # SECOND: its second stage's BatchNorms see 2x2 maps, 8 values a channel
    cfg = dict(in_channels=16, out_channels=(16, 32), layer_nums=(1, 1),
               layer_strides=(1, 2))
    x = rng.randn(2, 4, 4, 16).astype(np.float32)
    jm = JaxSECOND(**cfg)
    v = perturb(jm.init(KEY, jnp.asarray(x)))
    shapes = jax.eval_shape(lambda: jm.apply(v, jnp.asarray(x)))
    cot = tuple(rng.randn(*s.shape).astype(np.float32) for s in shapes)
    out, dp, stats = _jax_train_vjp(jm, v, (jnp.asarray(x),),
                                    tuple(jnp.asarray(c) for c in cot))
    path = ("pts_backbone",)
    cases["SECOND"] = dict(
        kind="SECOND", cfg=cfg, state=port_state(v, path, "pts_backbone."),
        x=[t(x[r:r + 1]).permute(0, 3, 1, 2) for r in range(2)],
        cot=[tuple(t(c[r:r + 1]).permute(0, 3, 1, 2) for c in cot)
             for r in range(2)])
    want["SECOND"] = dict(
        out=[np.asarray(o).transpose(0, 3, 1, 2) for o in out], dx=None,
        grads=port_state({"params": dp}, path, "pts_backbone."),
        buffers=port_state({**v, "batch_stats": stats}, path,
                           "pts_backbone."))
    return cases, want


@pytest.fixture(scope="module")
def bn_ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bn"))
    cases, want = _bn_cases(np.random.RandomState(0))
    torch.save(cases, osp.join(path, "bn_cases.pt"))
    spawn_ranks(torch_dist_workers.bn_rank, 2, path, path)
    ranks = [torch.load(osp.join(path, f"bn_rank{r}.pt")) for r in range(2)]
    return ranks, want


def _close(got, want, rel, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * scale, err_msg=what)


@pytest.mark.parametrize("kind", ["BatchNorm2d", "MaskedBatchNorm", "SECOND"])
def test_two_ranks_train_as_the_jax_module_at_batch_two(bn_ranks, kind):
    ranks, want = bn_ranks
    got = [r[kind] for r in ranks]
    w = want[kind]
    for i, wo in enumerate(w["out"]):
        _close(torch.cat([g["out"][i] for g in got]).numpy(), wo, 1e-5,
               f"{kind} output {i}")
    if w["dx"] is not None:
        _close(torch.cat([g["dx"] for g in got]).numpy(), w["dx"], 1e-4,
               f"{kind} d_x")
    for g in got:
        assert set(g["grads"]) == {k for k in w["grads"]
                                   if not k.endswith("num_batches_tracked")}
        for n, wg in g["grads"].items():
            _close(wg.numpy(), w["grads"][n], 1e-4, f"{kind} grad {n}")
        stats = [n for n in g["buffers"] if n.endswith(("running_mean",
                                                        "running_var"))]
        assert stats and len(stats) == sum(
            1 for n in w["buffers"] if n.endswith(("running_mean",
                                                   "running_var")))
        for n in stats:
            _close(g["buffers"][n].numpy(), w["buffers"][n], 1e-5,
                   f"{kind} {n}")
            assert torch.equal(g["buffers"][n], got[0]["buffers"][n])


@pytest.fixture(scope="module")
def lc_ranks(tmp_path_factory):
    """ddp_check's two ranks and its one process, on the CPU."""
    work = str(tmp_path_factory.mktemp("ddp"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = ddp_check.run_ranks(2, "cpu", work)
        ref = ddp_check.one_process(2, "cpu")
    finally:
        torch.set_num_threads(threads)
    return ranks, ref


def test_two_ranks_step_as_one_process_at_batch_two(lc_ranks):
    ranks, ref = lc_ranks
    worst = ddp_check.compare(ranks, ref)
    assert worst["losses"] <= 1e-5
    for step, want in enumerate(ref["steps"]):
        got = ranks[0]["steps"][step]["metrics"]
        for k in ("loss", "loss_cls", "loss_bbox", "grad_norm"):
            np.testing.assert_allclose(got[k], want["metrics"][k], rtol=1e-5,
                                       err_msg=k)
        # LiDAR BatchNorms' running statistics: 21 masked, 4 + 2 flax ones
        assert len(want["stats"]) == 2 * (21 + 4 + 2)
    assert ranks[0]["steps"][0]["grads"].keys() == ref["steps"][0]["grads"].keys()


def test_ranks_stay_bit_identical(lc_ranks):
    ranks, _ = lc_ranks
    state = ranks[0]["state"]
    assert any("running_var" in k for k in state)
    for k, v in state.items():
        assert torch.equal(ranks[1]["state"][k], v), k


def test_ranks_draw_the_same_modality_flags(lc_ranks):
    ranks, _ = lc_ranks
    assert ranks[0]["flags"] == ranks[1]["flags"]
    assert set(ranks[0]["flags"]) <= {(1.0, 1.0), (1.0, 0.0), (0.0, 1.0)}


def test_eval_gather_gives_the_one_process_metric(lc_ranks):
    ranks, ref = lc_ranks
    assert ref["metric"]["mAP"] > 0
    for r in ranks:
        assert json.dumps(r["metric"]) == json.dumps(ref["metric"])


def test_process_allgather_stacks_the_ranks(lc_ranks):
    ranks, _ = lc_ranks
    for r in ranks:
        g = r["gathered"]
        assert g["rank"].shape == (2, 1) and g["rank"].ravel().tolist() == [0, 1]
        assert g["ones"].shape == (2, 2, 3) and g["ones"].dtype == bool
        assert g["ones"].all()


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _torchrun(module, *args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", module, *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def test_clis_under_torch_distributed_run(tmp_path, capsys, one_thread):
    """Two gloo ranks train 2 steps on the fake tree's 3 samples (global
    batch 2); rank 0 alone writes the log, metrics and checkpoint, which
    keeps the reference keys; the test CLI under the same launcher gathers
    the one val sample's results as one process gives them."""
    cfg = fake_nuscenes_tree(str(tmp_path / "tree"))
    work = str(tmp_path / "work")
    r = _torchrun("unibev_tpu_torch.tools.train_UniBEV", cfg, "--device",
                  "cpu", "--launcher", "pytorch", "--max-steps", "2",
                  "--work-dir", work, "--cfg-options", "log_config.interval=1",
                  cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    with open(osp.join(work, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    assert len(steps) == 1                    # 3 samples // global batch 2
    assert all(np.isfinite(s["loss"]) for s in steps)
    logs = [n for n in os.listdir(work) if n.endswith(".log")]
    assert len(logs) == 1                     # rank 0's
    ckpt = osp.join(work, "checkpoints", "1.pth")
    state = torch.load(ckpt, weights_only=False)
    assert not any(k.startswith("module.") for k in state["model"])
    assert len(state["rank_generators"]) == 2
    assert not torch.equal(*state["rank_generators"])

    out2 = str(tmp_path / "two.json")
    r = _torchrun("unibev_tpu_torch.tools.test_UniBEV", cfg, ckpt,
                  "--device", "cpu", "--launcher", "pytorch", "--out", out2,
                  cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    metrics = [line for line in r.stdout.splitlines() if '"mAP"' in line]
    assert len(metrics) == 1                  # rank 0 prints
    out1 = str(tmp_path / "one.json")
    capsys.readouterr()
    assert test_UniBEV.main([cfg, ckpt, "--device", "cpu", "--out", out1]) == 0
    one_metrics = [line for line in capsys.readouterr().out.splitlines()
                   if '"mAP"' in line]
    with open(out1) as f1, open(out2) as f2:
        one, two = json.load(f1), json.load(f2)
    assert len(one) == 1 and two == one
    assert json.loads(metrics[0]) == json.loads(one_metrics[0])
