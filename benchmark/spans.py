"""Ranges around the calls into each layer of the port, put in by the
benchmark, for the traced part of a run.

A layer range (``layer:<name>``) wraps a module's forward or a method of
the detector; an op range (``op:<name>``) wraps the name a layer module
calls an op by, and records the shapes of each call for the op's work
formula (``work/<op>.py``, which may keep more of a call: its ``keep(rec,
args)``, read after the trace by its ``settle(rec)``).  Which module or
name each range wraps is the detector file's data (``LAYERS``, ``OPS``);
``install`` puts in those the model has and takes them out again on exit.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Callable, Dict, List

import torch
from torch import nn

# ranges around library calls the port makes (module, name, layer): the
# gradient clipping of the train step belongs to the optimizer's layer
LIBRARY = (("torch.nn.utils", "clip_grad_norm_", "optimizer"),)


def _shapes(name: str, args, out) -> Dict:
    """What an op's work formula reads of one call: every tensor argument's
    shape and item size, in order, and the output's."""
    rec = dict(fn=name, args=[(tuple(a.shape), a.element_size())
                              if isinstance(a, torch.Tensor) else None
                              for a in args])
    if isinstance(out, torch.Tensor):
        rec["out"] = (tuple(out.shape), out.element_size())
    return rec


def _work(op: str):
    from benchmark.spec import load_file
    return load_file("work", op)


def settle(calls: Dict[str, List]) -> None:
    """Let each op's work formula finish its calls' records after the trace
    (``settle``: a sparse conv's rulebook becomes its count of live taps)."""
    for op, recs in calls.items():
        finish = getattr(_work(op), "settle", None) if recs else None
        if finish is not None:
            for rec in recs:
                finish(rec)


def _wrap(label: str, fn: Callable, calls: List | None = None,
          name: str = "", keep: Callable | None = None) -> Callable:
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            out = fn(*args, **kwargs)
        if calls is not None:
            rec = _shapes(name, args, out)
            if keep is not None:
                keep(rec, args)
            calls.append(rec)
        return out
    return wrapped


@contextlib.contextmanager
def install(model: nn.Module, layers: Dict, ops: Dict):
    """Ranges on ``model`` and the port's op names inside: ``layers`` {layer:
    (attribute paths from the detector; a path names a submodule, whose
    forward is wrapped, or a bound method of one)} and ``ops`` {op: ((module
    of the port, the name a layer calls the op by), ...)}; yields {op: [the
    shapes of each call]}."""
    calls: Dict[str, List] = {op: [] for op in ops}
    undo = []
    modules = dict(model.named_modules())
    for layer, paths in layers.items():
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
    for op, sites in ops.items():
        keep = getattr(_work(op), "keep", None)
        for module_name, attr in sites:
            mod = importlib.import_module(module_name)
            undo.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, _wrap(f"op:{op}", getattr(mod, attr),
                                     calls[op], attr, keep))
    try:
        yield calls
    finally:
        for owner, attr, old in reversed(undo):
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
