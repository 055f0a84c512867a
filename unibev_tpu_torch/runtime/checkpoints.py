"""Checkpoints: the training state, resume, warm start and model weights.

Counterpart of ``unibev_tpu/runtime/checkpoints.py`` with ``torch.save``
files in place of orbax directories: the reference's CheckpointHook cadence
(every ``interval`` epochs, its config's ``checkpoint_config.interval``)
plus CheckpointLateStageHook (every epoch from ``start``), full resume
(model, optimizer, scheduler, step, epoch and the training generator), and
weights loaded by ``state_dict`` key with the JAX package's tolerance for a
checkpoint that holds more or less than the model (an LC checkpoint
evaluated by the L or C inference configs).  The port's modules carry the
reference's key names, so a reference ``{'state_dict': ...}`` file loads as
it is.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import re
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn

logger = logging.getLogger("unibev_tpu_torch")

_STEP_FILE = re.compile(r"^(\d+)\.pth$")


def _save(obj: Any, path: str) -> None:
    """torch.save to a private name, then rename: a reader never sees half a
    file."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """``{step}.pth`` files under ``directory``, the newest ``max_to_keep``
    kept."""

    def __init__(self, directory: str, interval: int = 6,
                 late_stage_start: Optional[int] = None, max_to_keep: int = 10):
        self.directory = osp.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.interval = interval
        self.late_stage_start = late_stage_start
        self.max_to_keep = max_to_keep

    def should_save(self, epoch: int) -> bool:
        """Reference cadence: every ``interval`` epochs, plus every epoch from
        ``late_stage_start`` (CheckpointLateStageHook semantics)."""
        if (epoch + 1) % self.interval == 0:
            return True
        if self.late_stage_start is not None and (epoch + 1) >= self.late_stage_start:
            return True
        return False

    def path(self, step: int) -> str:
        return osp.join(self.directory, f"{step}.pth")

    def steps(self) -> List[int]:
        return _steps_in(self.directory)

    def save(self, step: int, state: Dict[str, Any]) -> str:
        path = self.path(step)
        _save(state, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return _load(self.path(step))


def _steps_in(directory: str) -> List[int]:
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                               os.listdir(directory)) if m)


def _load(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state_from(path: str) -> Dict[str, Any]:
    """The training state at an EXPLICIT path (the reference's
    ``--resume-from``): a :class:`CheckpointManager` directory (its newest
    step) or one ``.pth`` file.  Raises FileNotFoundError rather than
    training from scratch."""
    path = osp.abspath(path)
    if osp.isdir(path):
        steps = _steps_in(path)
        if not steps:
            raise FileNotFoundError(f"--resume-from: no checkpoint in {path}")
        path = osp.join(path, f"{steps[-1]}.pth")
    elif not osp.isfile(path):
        raise FileNotFoundError(f"--resume-from: no checkpoint at {path}")
    return _load(path)


def save_params(path: str, model: nn.Module) -> None:
    """The model's weights as a reference-style ``{'state_dict': ...}``."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    _save({"state_dict": model.state_dict()}, path)


class LoadReport(NamedTuple):
    copied: List[str]     # model keys loaded from the checkpoint
    kept: List[str]       # model keys that kept their initialization
    dropped: List[str]    # checkpoint keys the model does not have


def _subtrees(keys: List[str], model_keys) -> List[str]:
    """Each key cut at its first dotted prefix the model lacks: the
    checkpoint subtrees that were not loaded (``img_backbone`` for an L
    model)."""
    prefixes = {".".join(k.split(".")[:i]) for k in model_keys
                for i in range(1, k.count(".") + 2)}
    out: Dict[str, int] = {}
    for k in keys:
        parts = k.split(".")
        i = next(i for i in range(1, len(parts) + 1)
                 if ".".join(parts[:i]) not in prefixes)
        sub = ".".join(parts[:i])
        out[sub] = out.get(sub, 0) + 1
    return [f"{s} ({n} keys)" if n > 1 else s for s, n in out.items()]


def load_params(path: str, model: nn.Module) -> LoadReport:
    """Load the weights in ``path`` into ``model``, tolerating a mismatch,
    LOUDLY (the JAX package's ``_merge_intersection`` on state_dict keys).

    ``path`` holds a training checkpoint (``model``), a reference-style
    ``{'state_dict': ...}`` or a bare state_dict.  Matching keys are copied
    (cast to the model's dtype); model-only keys and keys whose shapes differ
    keep their initialization; checkpoint-only keys are dropped.  Every kept
    key and every dropped subtree is logged (a converter fault must never
    become an accuracy loss without a word)."""
    raw = _load(path)
    if "model" in raw and isinstance(raw["model"], dict):
        raw = raw["model"]
    elif "state_dict" in raw and isinstance(raw["state_dict"], dict):
        raw = raw["state_dict"]
    own = model.state_dict()
    copied, kept = [], []
    with torch.no_grad():
        for k, v in own.items():
            if k not in raw:
                kept.append(k)
                logger.warning(f"load_params: '{k}' missing in checkpoint "
                               f"{path}: keeping initialization")
            elif tuple(raw[k].shape) != tuple(v.shape):
                kept.append(k)
                logger.warning(f"load_params: '{k}' (shape "
                               f"{tuple(raw[k].shape)} != {tuple(v.shape)}) in "
                               f"{path}: keeping initialization")
            else:
                v.copy_(raw[k])
                copied.append(k)
    dropped = [k for k in raw if k not in own]
    for sub in _subtrees(dropped, own):
        logger.info(f"load_params: checkpoint subtree '{sub}' not in model: "
                    f"ignored")
    logger.info(f"load_params: {len(copied)} keys loaded from {path}, "
                f"{len(kept)} kept their initialization, {len(dropped)} "
                f"checkpoint keys ignored")
    return LoadReport(copied, kept, dropped)
