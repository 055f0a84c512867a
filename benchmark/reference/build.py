"""Build the reference model from a repository config file.

A frozen copy of the port's ``flagship.model_cfg_from_config``: ``model``
without its ``type``, ``use_lidar`` / ``use_camera`` from
``input_modality`` where ``model`` does not set them.  The class is the one
the detector file of the config's ``model.type`` names (its
``REFERENCE``).  The reference always computes in float32, whatever
``dtype`` the file names; the model is built on the meta device, in eval
mode with gradients off, and takes its values from a state dict.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from benchmark.reference.config.config import Config


def _frozen(obj):
    if isinstance(obj, dict):
        return {k: _frozen(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return tuple(_frozen(v) for v in obj)
    return obj


def model_cfg(path) -> dict:
    """The detector's arguments from the config file at ``path``, float32."""
    cfg = Config.fromfile(os.fspath(path))
    model = _frozen(dict(cfg["model"]))
    model.pop("type", None)
    modality = cfg.get("input_modality") or {}
    for key in ("use_lidar", "use_camera"):
        if key in modality:
            model.setdefault(key, modality[key])
    model["dtype"] = torch.float32
    return model


def build_meta(cls, path) -> nn.Module:
    """The reference model ``cls`` of the config file at ``path``, shapes
    only."""
    with torch.device("meta"):
        return cls(**model_cfg(path)).eval().requires_grad_(False)


def build(cls, path, state, device) -> nn.Module:
    """The reference model ``cls`` on ``device`` with ``state`` (any float
    dtype) loaded as float32."""
    model = build_meta(cls, path).to_empty(device=device)
    model.load_state_dict({k: v.float() if v.is_floating_point() else v
                           for k, v in state.items()})
    return model
