"""Faults planted under the timed path, to read what the check makes of
them (``calibrate.py --fault``, the harness's tests).  Each wraps the call
the window drives: ``fault(call, model) -> call``.  These know nothing of
a detector's modules; a detector file may add its own (``FAULTS``).

Two break a scene's state through the batch alone (scene traffic,
``traffic.py``): ``scene_never_starts`` gives every call the first batch's
``scene_id``, so state leaks from the warm-up and across scenes;
``scene_always_starts`` gives each call a fresh one, so no history is
used."""

from __future__ import annotations

import itertools

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


def decode_altered(call, model):
    """One sample's decoded boxes altered where ``predict`` returns them."""
    def broken(batch):
        out = dict(call(batch))
        boxes = out["bboxes"].clone()
        boxes[0, :, 0] += 0.5
        out["bboxes"] = boxes
        return out
    return broken


def scene_never_starts(call, model):
    """Every call's ``scene_id`` set to the first batch's value."""
    first = []

    def broken(batch):
        if not first:
            first.append(batch["scene_id"])
        return call(dict(batch, scene_id=first[0]))
    return broken


def scene_always_starts(call, model):
    """Each call given a ``scene_id`` no call had before."""
    fresh = itertools.count(1)

    def broken(batch):
        return call(dict(batch, scene_id=batch["scene_id"]
                         + next(fresh) * 2 ** 40))
    return broken


FAULTS = {f.__name__: f for f in (half_batch, state_unchanged, decode_altered,
                                  scene_never_starts, scene_always_starts)}
