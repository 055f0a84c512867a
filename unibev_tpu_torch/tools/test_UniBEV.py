#!/usr/bin/env python3
"""Evaluate UniBEV with the PyTorch port, on one CUDA card (or the CPU).

    python -m unibev_tpu_torch.tools.test_UniBEV CONFIG [CHECKPOINT]
        [--out results.json] [--format-only] [--show-dir DIR]
        [--cfg-options key=value ...] [--synthetic-data] [--max-samples N]
        [--device cuda|cpu]

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
from unibev_tpu_torch.parallel.dist import shard_indices
from unibev_tpu_torch.registry import DATASETS
from unibev_tpu_torch.runtime.checkpoints import load_params
from unibev_tpu_torch.runtime.logging_utils import get_root_logger
from unibev_tpu_torch.runtime.predict import predict_dataset
from unibev_tpu_torch.tools.cli_common import (cli_device, load_config,
                                               single_process)

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
    p.add_argument("--tmpdir", help="accepted; one process gathers nothing")
    p.add_argument("--gpu-collect", action="store_true",
                   help="accepted; one process gathers nothing")
    p.add_argument("--launcher", default="none")
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
    single_process(args.launcher)
    device = cli_device(args.device)
    cfg = load_config(args.config, args.cfg_options)
    logger = get_root_logger()

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

    def ms(times):
        return 1000 * float(np.median(times[1:] or times))

    summary = dict(results=results, metrics=None, sca_overflow=sca_overflow,
                   ms_per_sample=ms(walls), predict_ms=ms(predicts),
                   wait_ms=ms(waits))
    logger.info(f"{len(results)} samples: {summary['ms_per_sample']:.2f} "
                f"ms/sample (predict {summary['predict_ms']:.2f}, loader "
                f"wait {summary['wait_ms']:.2f}; medians after the first "
                f"batch), sca_overflow {sca_overflow}")

    if args.out:
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
        print(json.dumps(metrics))
        summary["metrics"] = metrics
    return summary


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
    sys.exit(main())
