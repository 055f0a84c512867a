"""The correctness check: what the timed path produced, against the plain
reference on the same weights and inputs.

Forward hooks on the port's modules keep, for a sample of the window's
calls drawn from the seed, each layer's output (copied to the host as it
is produced, on the stream, without waiting): the camera neck, the LiDAR
neck, the camera and LiDAR BEV encoders, the fused BEV map the decoder
takes, the decoder's states and reference points and the head's class
scores and boxes of every decoder layer; and, from the model's forward,
the LiDAR branch's voxel counts and the sparse convs' overflow.  After the window the
reference (``reference/``, float32, TF32 off) runs the same batches and the
same hooks give its outputs.  Each number compared is the largest, over the
sampled calls and the samples of each, of one layer's relative L2 error
``|port - ref| / |ref|`` on one sample, or, for the counts, the largest
absolute difference.  ``limits/<workload>.json`` holds each number's limit.

The decoder and the head's branches are compared step by step from the
port's own state (``forced``): each of the six decoder layers, run by the
reference on the port's input to that layer (its query, the fused BEV map,
the positions and the reference points the port refined), against the
port's output of that layer; the reference points, the first layer's
against the reference's from the port's query positions and each later
layer's against the reference's refinement of the layer before (its state
and points); the class and box branches of every layer on the port's
decoder states; and what ``predict`` returned (boxes, scores, labels,
validity) against the reference's decoding of the port's last layer,
row by row.  Run end to end, the six layers' box
refinement moves each layer's sampling points by what the layers before it
rounded, and the last layers' outputs then differ by 10-25% in bf16 and in
fp8 alike, which no limit separates; the decoder's input, the fused map,
is compared end to end (``fused``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

# name: (module path, how to read it from the module's output and inputs)
CAPTURES = {
    "img_feat": ("img_neck", lambda out, args: out[0]),
    "pts_feat": ("pts_neck", lambda out, args: out),
    "img_bev": ("pts_bbox_head.transformer.img_bev_encoder",
                lambda out, args: out[0]),
    "pts_bev": ("pts_bbox_head.transformer.pts_bev_encoder",
                lambda out, args: out),
    "fused": ("pts_bbox_head.transformer.decoder", lambda out, args: args[1]),
    "voxels": ("", lambda out, args: out.get("num_distinct_voxels")),
    "overflow": ("", lambda out, args: out.get("sparse_overflow")),
}
# what the step-by-step check reads of the port alone
FORCED = {
    "dec_query": ("pts_bbox_head.transformer.decoder", lambda out, args: args[0]),
    "dec_pos": ("pts_bbox_head.transformer.decoder", lambda out, args: args[2]),
    "states": ("pts_bbox_head.transformer.decoder", lambda out, args: out[0]),
    "refs": ("pts_bbox_head.transformer.decoder", lambda out, args: out[1]),
    "cls_out": ("pts_bbox_head", lambda out, args: out["all_cls_scores"]),
    "box_out": ("pts_bbox_head", lambda out, args: out["all_bbox_preds"]),
}
# numbers compared exactly (counts); the others by relative L2 error
EXACT = ("voxels", "overflow", "decode")
# what predict returns, compared row by row
DECODED = ("scores", "labels", "valid", "bboxes")


def per_sample(name: str, t: torch.Tensor, batch: int) -> torch.Tensor:
    """``t`` as (batch, -1) float32 rows, one a sample."""
    t = t.float()
    if name == "overflow":                     # one count a forward
        return t.reshape(1, -1)
    return t.reshape(batch, -1)


class Capture:
    """Forward hooks on a model that keep the outputs of :data:`CAPTURES`
    (and, with ``forced``, of :data:`FORCED`) while armed, copied to the
    host without waiting."""

    def __init__(self, model: nn.Module, forced: bool = False):
        self.records: Dict[int, Dict[str, torch.Tensor]] = {}
        self._current: Optional[Dict[str, torch.Tensor]] = None
        self._handles = []
        self._what = dict(CAPTURES, **(FORCED if forced else {}))
        modules = dict(model.named_modules())
        paths: Dict[str, List[str]] = {}
        for name, (path, _) in self._what.items():
            if path in modules:
                paths.setdefault(path, []).append(name)
        for path, names in paths.items():
            self._handles.append(modules[path].register_forward_hook(
                self._hook(names)))

    def _hook(self, names: List[str]) -> Callable:
        def hook(module, args, out):
            if self._current is None:
                return
            for name in names:
                t = self._what[name][1](out, args)
                if isinstance(t, torch.Tensor):
                    self._current[name] = t.detach().to("cpu",
                                                        non_blocking=True)
        return hook

    def outputs(self, out: Dict[str, torch.Tensor]) -> None:
        """Keep the armed call's own outputs (their host copies)."""
        if self._current is not None:
            self._current["decoded"] = out

    def arm(self, key: Optional[int]) -> None:
        """Keep the next call's outputs under ``key`` (None: keep none)."""
        self._current = None if key is None else self.records.setdefault(key, {})

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


def compare(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
            batch: int) -> Dict[str, float]:
    """Each number of one call: relative L2 error per sample, the largest
    over the samples; counts by their largest absolute difference.  A layer
    the reference ran and the port did not reads infinity."""
    out: Dict[str, float] = {}
    for name, r in want.items():
        if name == "decoded":
            continue
        if name not in got:
            out[name] = float("inf")
            continue
        g = per_sample(name, got[name], batch)
        r = per_sample(name, r, batch)
        if g.shape != r.shape:
            out[name] = float("inf")
        elif name in EXACT:
            out[name] = float((g - r).abs().max())
        else:
            err = (g - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)
            out[name] = float(err.max())
    return out


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest over the samples (dim 0) of the relative L2 error."""
    g = got.float().reshape(got.shape[0], -1)
    w = want.float().reshape(want.shape[0], -1)
    return float(((g - w).norm(dim=1) / w.norm(dim=1).clamp(min=1e-30)).max())


def _rows(d: Dict[str, torch.Tensor], b: int, floor: float):
    """Sample ``b``'s decoded rows scored above ``floor``, in one order."""
    rows = torch.cat([d[k][b].float().reshape(d["scores"].shape[1], -1).cpu()
                      for k in DECODED], dim=1).double()
    rows = rows[rows[:, 0] > floor].numpy()
    return rows[np.lexsort(rows.T[::-1])]


def decode_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
               ) -> float:
    """Rows of ``predict``'s output that differ from the reference's
    decoding, over the samples.  Rows tied with the lowest score either
    side kept are left out: top-k may keep any row of such a tie."""
    if not all(k in got for k in DECODED):
        return float("inf")
    diff = 0
    for b in range(want["scores"].shape[0]):
        floor = float(max(got["scores"][b].float().min(),
                          want["scores"][b].float().min()))
        g, w = _rows(got, b, floor), _rows(want, b, floor)
        if g.shape != w.shape:
            diff += abs(g.shape[0] - w.shape[0]) + min(g.shape[0], w.shape[0])
        else:
            diff += int((g != w).any(axis=1).sum())
    return float(diff)


@torch.no_grad()
def forced(ref: nn.Module, got: Dict[str, torch.Tensor],
           device) -> Dict[str, float]:
    """The decoder layers and the head's branches of the reference ``ref``
    run step by step on the port's own state ``got`` (:data:`FORCED`):
    ``decoder`` (each layer's output), ``refs`` (each layer's reference
    points), ``cls`` and ``box`` (each layer's class scores and boxes),
    each the largest over layers and samples; and ``decode``, the rows of
    ``predict``'s output that differ from the reference's decoding of the
    port's last layer."""
    from benchmark.reference.models.layers import inverse_sigmoid
    if "states" not in got:
        return {}
    head = ref.pts_bbox_head
    tr = head.transformer
    on = {k: got[k].to(device).float() for k in FORCED if k in got}
    value, pos = got["fused"].to(device).float(), on["dec_pos"]
    states, refs = on["states"], on["refs"]
    query = on["dec_query"]
    pr = head.pc_range
    dec = cls = box = 0.0
    points = _rel(refs[0], torch.sigmoid(tr.reference_points(pos)))
    last = len(tr.decoder.layers) - 1
    for lvl, layer in enumerate(tr.decoder.layers):
        out = layer(query, value, pos, refs[lvl][..., None, :2],
                    ((tr.bev_h, tr.bev_w),))
        dec = max(dec, _rel(states[lvl], out))
        query = states[lvl]
        cls = max(cls, _rel(on["cls_out"][lvl],
                            head.cls_branches[lvl](states[lvl])))
        reference = inverse_sigmoid(refs[lvl])
        tmp = head.reg_branches[lvl](states[lvl])
        xy = torch.sigmoid(tmp[..., 0:2] + reference[..., 0:2])
        z = torch.sigmoid(tmp[..., 4:5] + reference[..., 2:3])
        if lvl < last:
            points = max(points, _rel(refs[lvl + 1],
                                      torch.cat([xy, z], dim=-1)))
        want = torch.cat([xy[..., 0:1] * (pr[3] - pr[0]) + pr[0],
                          xy[..., 1:2] * (pr[4] - pr[1]) + pr[1], tmp[..., 2:4],
                          z * (pr[5] - pr[2]) + pr[2], tmp[..., 5:]], dim=-1)
        box = max(box, _rel(on["box_out"][lvl], want))
    numbers = {"decoder": dec, "refs": points, "cls": cls, "box": box}
    if "decoded" in got:
        decoded = head.get_bboxes({"all_cls_scores": on["cls_out"],
                                   "all_bbox_preds": on["box_out"]})
        numbers["decode"] = decode_gap(got["decoded"], decoded)
    return numbers


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over the calls."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, number, limit)]): every limited number present and
    within its limit (counts: at most the limit, which is 0)."""
    rows = [(k, numbers.get(k, float("inf")), v) for k, v in sorted(limits.items())]
    correct = all(n == n and n <= lim for _, n, lim in rows)
    return correct, rows


def sample_calls(gen: torch.Generator, within: int, pool: int, count: int
                 ) -> List[int]:
    """``count`` call indices below ``within``, drawn from ``gen``, on
    distinct batches of the pool where the pool allows."""
    order = torch.randperm(within, generator=gen).tolist()
    picked, seen = [], set()
    for i in order:
        if i % pool not in seen or len(seen) >= pool:
            picked.append(i)
            seen.add(i % pool)
        if len(picked) == count:
            break
    return sorted(picked)
