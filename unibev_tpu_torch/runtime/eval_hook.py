"""In-training evaluation (the reference's EvalHook).

Counterpart of ``unibev_tpu/runtime/eval_hook.py::make_eval_fn`` on one
process: the predict loop of the test CLI (``runtime/predict.py``) over the
val dataset, then the nuScenes metric.  The multi-process pack, allgather
and unpack of the JAX hook come with the data-parallel step (ROADMAP A7).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from unibev_tpu_torch.data.eval import evaluate_detections
from unibev_tpu_torch.data.nuscenes_dataset import collate
from unibev_tpu_torch.parallel.dist import shard_indices
from unibev_tpu_torch.runtime.predict import predict_dataset


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


def make_eval_fn(max_samples: Optional[int] = None):
    """eval_fn(model, dataset) -> the metrics dict, for the Runner."""

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
        classes = getattr(dataset, "classes", [str(i) for i in range(10)])
        return evaluate_detections(preds, gts, classes)

    return eval_fn
