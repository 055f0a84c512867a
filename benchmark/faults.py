"""Faults planted under the timed path, to read what the check makes of
them (``calibrate.py --fault``, the harness's tests).  Each wraps the call
the window drives: ``fault(call, model) -> call``."""

from __future__ import annotations

import torch


def half_batch(call, model):
    """Half of the batch left out: a train step's mean taken over the rest;
    a predict call's first half answered twice."""
    def broken(batch):
        B = batch["lidar2img"].shape[0]
        if model.training:
            return call({k: v[:B // 2] if v.shape[:1] == (B,) else v
                         for k, v in batch.items()})
        return call({k: torch.cat([v[:B // 2]] * 2)[:B]
                     if v.shape[:1] == (B,) else v for k, v in batch.items()})
    return broken


def state_unchanged(call, model):
    """A train step that returns the state it was given."""
    def broken(batch):
        before = [p.detach().clone() for p in model.parameters()]
        out = call(batch)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return out
    return broken


def answer_altered(call, model):
    """One sample's boxes altered where the head produces them."""
    def hook(module, args, out):
        out["all_bbox_preds"][:, 0, :, 0] += 0.5
        return out
    model.pts_bbox_head.register_forward_hook(hook)
    return call


def decode_altered(call, model):
    """One sample's decoded boxes altered where ``predict`` returns them."""
    def broken(batch):
        out = dict(call(batch))
        boxes = out["bboxes"].clone()
        boxes[0, :, 0] += 0.5
        out["bboxes"] = boxes
        return out
    return broken


FAULTS = {f.__name__: f for f in (half_batch, state_unchanged, answer_altered,
                                  decode_altered)}
