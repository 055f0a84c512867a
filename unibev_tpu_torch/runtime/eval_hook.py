"""In-training evaluation (the reference's EvalHook).

Counterpart of ``unibev_tpu/runtime/eval_hook.py::make_eval_fn``: the
predict loop of the test CLI (``runtime/predict.py``) over the val dataset,
then the nuScenes metric.  Under a process group each rank predicts its
share of the samples (``shard_indices``, padded by wrapping around); the
per-sample results are packed into fixed-shape arrays
(:func:`_pack_results`), gathered on the host by ``process_allgather`` and
merged in dataset order with each padded duplicate dropped
(:func:`_unpack_results`), so every rank scores all the samples once, as
one process would.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from unibev_tpu_torch.data.eval import evaluate_detections
from unibev_tpu_torch.data.nuscenes_dataset import collate
from unibev_tpu_torch.parallel.dist import (is_distributed, process_allgather,
                                            shard_indices)
from unibev_tpu_torch.runtime.predict import predict_dataset

_MAX_PRED = 300   # NMSFreeCoder max_num (reference config :377)


def _gt_for(dataset, i) -> dict:
    """Sample ``i``'s ground truth: from the annotations where the dataset
    has them, else from the sample itself (synthetic datasets)."""
    if hasattr(dataset, "get_ann_info"):
        ann = dataset.get_ann_info(int(i))
        return dict(boxes=np.asarray(ann["gt_bboxes_3d"],
                                     np.float32).reshape(-1, 9),
                    labels=np.asarray(ann["gt_labels_3d"]))
    sample = dataset[int(i)]
    g = np.asarray(sample["gt_bboxes"])
    v = np.asarray(sample["gt_valid"])
    return dict(boxes=g[v], labels=np.asarray(sample["gt_labels"])[v])


def _pack_results(preds: List[dict], gts: List[dict], idxs: np.ndarray,
                  max_gt: int) -> Dict[str, np.ndarray]:
    """Fixed-shape arrays of this rank's results for the gather: at most
    ``_MAX_PRED`` predictions and ``max_gt`` ground-truth boxes a sample.
    ``max_gt`` must be the largest count over every rank (all ranks pack
    the same shapes), so that no crowded sample is cut."""
    n = len(preds)
    out = dict(
        idx=np.asarray(idxs[:n], np.int32),
        pred_boxes=np.zeros((n, _MAX_PRED, 9), np.float32),
        pred_scores=np.zeros((n, _MAX_PRED), np.float32),
        pred_labels=np.zeros((n, _MAX_PRED), np.int32),
        pred_n=np.zeros((n,), np.int32),
        gt_boxes=np.zeros((n, max_gt, 9), np.float32),
        gt_labels=np.zeros((n, max_gt), np.int32),
        gt_n=np.zeros((n,), np.int32),
    )
    for i, (p, g) in enumerate(zip(preds, gts)):
        np_, ng = min(len(p["boxes"]), _MAX_PRED), min(len(g["boxes"]), max_gt)
        out["pred_boxes"][i, :np_] = p["boxes"][:np_, :9]
        out["pred_scores"][i, :np_] = p["scores"][:np_]
        out["pred_labels"][i, :np_] = p["labels"][:np_]
        out["pred_n"][i] = np_
        out["gt_boxes"][i, :ng] = np.asarray(g["boxes"],
                                             np.float32).reshape(-1, 9)[:ng]
        out["gt_labels"][i, :ng] = g["labels"][:ng]
        out["gt_n"][i] = ng
    return out


def _unpack_results(gathered: Dict[str, np.ndarray]
                    ) -> Tuple[List[dict], List[dict]]:
    """Packed results (with or without a leading rank axis) merged in
    dataset order, the first occurrence of each sample index kept (the
    shards' padding repeats samples)."""
    def norm(a, trailing):
        a = np.asarray(a)
        return a.reshape((-1,) + a.shape[a.ndim - trailing:])

    idx = norm(gathered["idx"], 0)
    pb, ps, pl, pn = (norm(gathered[k], t) for k, t in (
        ("pred_boxes", 2), ("pred_scores", 1), ("pred_labels", 1),
        ("pred_n", 0)))
    gb, gl, gn = (norm(gathered[k], t) for k, t in (
        ("gt_boxes", 2), ("gt_labels", 1), ("gt_n", 0)))
    seen = set()
    preds, gts = [], []
    for j in np.argsort(idx, kind="stable"):
        i = int(idx[j])
        if i in seen:
            continue
        seen.add(i)
        k = int(pn[j])
        preds.append(dict(boxes=pb[j, :k], scores=ps[j, :k], labels=pl[j, :k]))
        k = int(gn[j])
        gts.append(dict(boxes=gb[j, :k], labels=gl[j, :k]))
    return preds, gts


def make_eval_fn(max_samples: Optional[int] = None):
    """eval_fn(model, dataset) -> the metrics dict, for the Runner.  Under a
    process group every rank must call it; each gets the same metrics."""

    def eval_fn(model, dataset) -> Dict[str, float]:
        n = len(dataset) if max_samples is None else min(len(dataset),
                                                         max_samples)
        idxs = shard_indices(n, shuffle=False, drop_last=False)
        preds, gts = [], []
        for chunk, _, _, out in predict_dataset(model, dataset, idxs, collate):
            for j, i in enumerate(chunk):
                valid = out["valid"][j].numpy()
                preds.append(dict(boxes=out["bboxes"][j].numpy()[valid],
                                  scores=out["scores"][j].numpy()[valid],
                                  labels=out["labels"][j].numpy()[valid]))
                gts.append(_gt_for(dataset, i))
        if is_distributed():
            local_max = max([len(g["boxes"]) for g in gts] + [1])
            global_max = int(np.max(process_allgather(
                np.asarray([local_max], np.int32))))
            preds, gts = _unpack_results(process_allgather(
                _pack_results(preds, gts, idxs, max_gt=global_max)))
        classes = getattr(dataset, "classes", [str(i) for i in range(10)])
        return evaluate_detections(preds, gts, classes)

    return eval_fn
