#!/usr/bin/env python3
"""Evaluate UniBEV with the PyTorch port, on CUDA cards (or the CPU).

    python -m unibev_tpu_torch.tools.test_UniBEV CONFIG [CHECKPOINT]
        [--out results.json] [--format-only] [--show-dir DIR]
        [--cfg-options key=value ...] [--synthetic-data] [--max-samples N]
        [--device cuda|cpu]
    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m unibev_tpu_torch.tools.test_UniBEV CONFIG CKPT --launcher pytorch ...

The counterpart of ``tools/test_UniBEV.py`` (the JAX package's test CLI)
with its flags.  The model is ``build_model_from_config`` of the config
(its inference build: the config's dtype); CHECKPOINT (a training
checkpoint, or a reference-style ``{'state_dict': ...}``) loads into it by
key, so an LC checkpoint serves the L and C inference configs.
``--out`` writes one dict per sample: ``sample_idx``, ``boxes_3d``,
``scores_3d``, ``labels_3d``, ``valid``.  On a dataset with annotations and
without ``--format-only`` the nuScenes metrics are printed as one JSON line.
Exits 1 when the camera cross-attention dropped hits beyond its top-K
capacity (``sca_overflow`` > 0): those predictions are not the reference's.
Under ``--launcher pytorch`` each rank predicts its share of the samples
and the results are gathered in dataset order on every rank (the JAX CLI's
fixed-shape gather, padded duplicates dropped); rank 0 writes ``--out``
and prints the metrics.
``main(argv)`` runs it in process and returns the exit code; ``run(args)``
returns the results and the loop's times.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time

import numpy as np

from unibev_tpu_torch.data.nuscenes_dataset import SyntheticNuScenes, collate
from unibev_tpu_torch.flagship import build_model_from_config
from unibev_tpu_torch.parallel.dist import (get_rank, is_distributed,
                                            process_allgather, shard_indices)
from unibev_tpu_torch.registry import DATASETS
from unibev_tpu_torch.runtime.checkpoints import load_params
from unibev_tpu_torch.runtime.logging_utils import get_root_logger
from unibev_tpu_torch.runtime.predict import predict_dataset
from unibev_tpu_torch.tools.cli_common import (cli_device, launch, load_config,
                                               log_level)

SYNTHETIC_KEYS = ("num_cams", "img_hw", "max_points", "max_gt", "seed")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test UniBEV (PyTorch port)")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="checkpoint (optional: random init if absent)")
    p.add_argument("--out", help="output results file (.json)")
    p.add_argument("--eval", nargs="+", default=["bbox"],
                   help="evaluation metrics")
    p.add_argument("--format-only", action="store_true")
    p.add_argument("--show", action="store_true",
                   help="accepted; images go to --show-dir")
    p.add_argument("--show-dir", help="directory to dump BEV images")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--fuse-conv-bn", action="store_true",
                   help="accepted; the frozen BNs are already affine")
    p.add_argument("--tmpdir", help="accepted; results are gathered in "
                                     "memory")
    p.add_argument("--gpu-collect", action="store_true",
                   help="accepted; results are gathered on the host")
    p.add_argument("--launcher", default="none",
                   choices=["none", "pytorch", "slurm", "mpi", "tpu"])
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def run(args) -> dict:
    """The test: returns ``results``, ``metrics`` (None without
    evaluation), ``sca_overflow`` and the loop's times: ``ms_per_sample``
    (the host's wall between batches, after the first), ``predict_ms`` and
    ``wait_ms`` (per sample, medians after the first batch: copy, predict
    and read-back; the wait for the loader)."""
    device = launch(args.launcher, cli_device(args.device))
    cfg = load_config(args.config, args.cfg_options)
    logger = get_root_logger(log_level=log_level(cfg.get("log_level", "INFO")))

    model = build_model_from_config(cfg, device, seed=args.seed)
    if args.checkpoint:
        load_params(args.checkpoint, model)
        logger.info(f"loaded checkpoint {args.checkpoint}")

    test_cfg = dict(cfg.data["test"]) if cfg.get("data") else {}
    if args.synthetic_data or test_cfg.get("type") == "SyntheticNuScenes":
        dataset = SyntheticNuScenes(
            length=args.max_samples or 4,
            **{k: v for k, v in test_cfg.items() if k in SYNTHETIC_KEYS})
    else:
        dataset = DATASETS.build(test_cfg)
    n = min(len(dataset), args.max_samples or len(dataset))
    idxs = shard_indices(n, shuffle=False, drop_last=False)

    results = []
    sca_overflow = -1
    walls, predicts, waits = [], [], []
    t_last = time.perf_counter()
    for chunk, metas, b, out in predict_dataset(model, dataset, idxs, collate):
        sca_overflow = max(sca_overflow, out["sca_overflow"])
        for j, i in enumerate(chunk):
            valid = out["valid"][j].numpy()
            results.append(dict(
                sample_idx=str(metas[j].get("sample_idx", int(i))),
                boxes_3d=out["bboxes"][j].tolist(),
                scores_3d=out["scores"][j].tolist(),
                labels_3d=out["labels"][j].tolist(),
                valid=valid.tolist()))
            if args.show_dir:
                from unibev_tpu_torch.utils.visualize import save_bev
                keep = valid & (out["scores"][j].numpy() > 0.3)
                save_bev(
                    osp.join(args.show_dir, f"sample_{int(i):04d}.png"),
                    points=(b["points"][j].cpu().numpy() if "points" in b
                            else None),
                    boxes=out["bboxes"][j].numpy()[keep],
                    labels=out["labels"][j].numpy()[keep],
                    pc_range=tuple(cfg.point_cloud_range)
                    if "point_cloud_range" in cfg else (-54, -54, -5, 54, 54, 3))
        now = time.perf_counter()
        walls.append((now - t_last) / len(chunk))
        predicts.append(out["predict_s"] / len(chunk))
        waits.append(out["wait_s"] / len(chunk))
        t_last = now
        if len(results) % 10 < len(chunk):
            logger.info(f"[{len(results)}/{len(idxs)}] samples done")

    if is_distributed():
        results, sca_overflow = _gather_results(results, idxs, sca_overflow)

    def ms(times):
        return 1000 * float(np.median(times[1:] or times))

    summary = dict(results=results, metrics=None, sca_overflow=sca_overflow,
                   ms_per_sample=ms(walls), predict_ms=ms(predicts),
                   wait_ms=ms(waits))
    logger.info(f"{len(results)} samples: {summary['ms_per_sample']:.2f} "
                f"ms/sample (predict {summary['predict_ms']:.2f}, loader "
                f"wait {summary['wait_ms']:.2f}; medians after the first "
                f"batch), sca_overflow {sca_overflow}")

    if args.out and get_rank() == 0:
        os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f)
        logger.info(f"wrote {args.out}")

    if (not args.format_only and not args.synthetic_data
            and hasattr(dataset, "infos")):
        from unibev_tpu_torch.data.eval import nuscenes_eval
        metrics = nuscenes_eval(results, dataset)
        metrics["sca_overflow"] = sca_overflow
        logger.info(f"Evaluation: {json.dumps(metrics, indent=2)}")
        if get_rank() == 0:
            print(json.dumps(metrics))
        summary["metrics"] = metrics
    return summary


def _gather_results(results, idxs, sca_overflow):
    """Every rank's result dicts in dataset order, each sample once (the
    first of the shards' padded repeats), and the largest ``sca_overflow``:
    fixed-shape arrays gathered by ``process_allgather``, the sample names
    as rows of bytes."""
    names = [r["sample_idx"].encode() for r in results]
    width = int(np.max(process_allgather(
        np.asarray([max(map(len, names), default=1)], np.int32))))
    packed = dict(
        idx=np.asarray(idxs[:len(results)], np.int32),
        name=np.array([list(n.ljust(width, b"\0")) for n in names], np.uint8)
        .reshape(len(names), width),
        boxes=np.asarray([r["boxes_3d"] for r in results], np.float32),
        scores=np.asarray([r["scores_3d"] for r in results], np.float32),
        labels=np.asarray([r["labels_3d"] for r in results], np.int64),
        valid=np.asarray([r["valid"] for r in results], bool),
        overflow=np.asarray([sca_overflow], np.int64))
    g = {k: v.reshape((-1,) + v.shape[2:])
         for k, v in process_allgather(packed).items()}
    seen, merged = set(), []
    for j in np.argsort(g["idx"], kind="stable"):
        i = int(g["idx"][j])
        if i in seen:
            continue
        seen.add(i)
        merged.append(dict(
            sample_idx=bytes(g["name"][j]).rstrip(b"\0").decode(),
            boxes_3d=g["boxes"][j].tolist(), scores_3d=g["scores"][j].tolist(),
            labels_3d=g["labels"][j].tolist(), valid=g["valid"][j].tolist()))
    return merged, int(g["overflow"].max())


def main(argv=None) -> int:
    summary = run(parse_args(argv))
    if summary["sca_overflow"] > 0:
        get_root_logger().error(
            f"sca_topk_overflow={summary['sca_overflow']}: the camera SCA "
            f"dropped pillar hits beyond rebatch_k; raise rebatch_k in the "
            f"config (the results above are degraded)")
        return 1
    return 0


if __name__ == "__main__":
    code = main()
    import torch
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    sys.exit(code)
