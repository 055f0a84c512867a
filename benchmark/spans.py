"""Ranges around the calls into each layer of the port, put in by the
benchmark (no program file has them yet), for the traced part of a run.

A layer range (``layer:<name>``) wraps a module's forward or a method of
the detector; an op range (``op:<name>``) wraps the name a layer module
calls an op by, and records the shapes of each call for the op's work
formula (``work/<op>.py``).  Which module or name each range wraps is the
data below; ``install`` puts in those the model has and takes them out
again on exit.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Callable, Dict, List

import torch
from torch import nn

# layer: (attribute paths from the detector; a path names a submodule, whose
# forward is wrapped, or a bound method of one)
LAYERS = {
    "camera_backbone": ("extract_img_feat",),
    "lidar_branch": ("extract_pts_feat",),
    "bev_encoders": ("pts_bbox_head.transformer.img_bev_encoder",
                     "pts_bbox_head.transformer.pts_bev_encoder"),
    "head": ("pts_bbox_head", "pts_bbox_head.get_bboxes"),
}

# ranges around library calls the port makes (module, name, layer): the
# gradient clipping of the train step belongs to the optimizer's layer
LIBRARY = (("torch.nn.utils", "clip_grad_norm_", "optimizer"),)

# op: (module of the port, the name a layer calls the op by)
OPS = {
    "dcn_fwd": (("unibev_tpu_torch.models.backbones.resnet",
                 "modulated_deform_conv2d"),),
    "msda_fwd": (("unibev_tpu_torch.models.attention.deformable",
                  "ms_deform_attn"),),
    "sparse_conv": (("unibev_tpu_torch.models.middle_encoder", "sparse_conv"),
                    ("unibev_tpu_torch.models.middle_encoder",
                     "subm_neighbor_idx"),
                    ("unibev_tpu_torch.models.middle_encoder",
                     "strided_neighbor_idx")),
}


def _shapes(name: str, args, out) -> Dict:
    """What an op's work formula reads of one call: every tensor argument's
    shape and item size, in order, the output's, and (sparse convs) the
    rulebook itself, whose live taps are counted after the trace."""
    rec = dict(fn=name, args=[(tuple(a.shape), a.element_size())
                              if isinstance(a, torch.Tensor) else None
                              for a in args])
    if isinstance(out, torch.Tensor):
        rec["out"] = (tuple(out.shape), out.element_size())
    if name == "sparse_conv":
        rec["nidx"], rec["rows"] = args[1], args[0].shape[0]
    return rec


def count_live(calls: Dict[str, List]) -> None:
    """Replace each sparse conv's rulebook by its count of live taps."""
    for rec in calls.get("sparse_conv", ()):
        if "nidx" in rec:
            rec["live"] = int((rec.pop("nidx") < rec["rows"]).sum())


def _wrap(label: str, fn: Callable, calls: List | None = None,
          name: str = "") -> Callable:
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            out = fn(*args, **kwargs)
        if calls is not None:
            calls.append(_shapes(name, args, out))
        return out
    return wrapped


@contextlib.contextmanager
def install(model: nn.Module):
    """Ranges on ``model`` and the port's op names inside; yields {op: [the
    shapes of each call]}."""
    calls: Dict[str, List] = {op: [] for op in OPS}
    undo = []
    modules = dict(model.named_modules())
    for layer, paths in LAYERS.items():
        for path in paths:
            owner_path, _, attr = path.rpartition(".")
            if path in modules:
                m = modules[path]
                undo.append((m, "forward", m.__dict__.get("forward")))
                m.forward = _wrap(f"layer:{layer}", m.forward)
            elif owner_path in modules and hasattr(modules[owner_path], attr):
                m = modules[owner_path]
                undo.append((m, attr, m.__dict__.get(attr)))
                setattr(m, attr, _wrap(f"layer:{layer}", getattr(m, attr)))
    for module_name, attr, layer in LIBRARY:
        mod = importlib.import_module(module_name)
        undo.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, _wrap(f"layer:{layer}", getattr(mod, attr)))
    for op, sites in OPS.items():
        for module_name, attr in sites:
            mod = importlib.import_module(module_name)
            undo.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, _wrap(f"op:{op}", getattr(mod, attr),
                                     calls[op], attr))
    try:
        yield calls
    finally:
        for owner, attr, old in reversed(undo):
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
