"""A tiny stateful detector, for the harness's tests only: the port's tiny
C model (``flagship.tiny_model_cfg``) whose camera BEV queries add half of
the previous frame's camera BEV of the same scene, and its twin built on
the plain reference.  A sample starts a scene (no history) where its
``scene_id`` differs from the one the model saw last in that slot of the
batch.  The state lives on the model, from one forward to the next."""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.models.detectors.unibev import UniBEV as _Reference


class History(nn.Module):
    """The previous frame's BEV, halved, where the sample's scene goes on;
    zeros where it starts.  Its output is what the queries add: the check
    compares it as a number of its own."""

    def forward(self, prev: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        return 0.5 * prev * keep[:, None, None].to(prev.dtype)


class SceneState:
    """The state of a detector built from UniBEV's modules: mixed in before
    the detector's class."""

    def __init__(self, **cfg):
        super().__init__(**cfg)
        self.history = History()
        self._prev = self._prev_scene = self._scene = None
        encoder = self.pts_bbox_head.transformer.img_bev_encoder
        encoder.register_forward_pre_hook(self._add_history)
        encoder.register_forward_hook(self._keep_bev)

    def forward(self, batch, *args, **kwargs):
        self._scene = batch["scene_id"]
        return super().forward(batch, *args, **kwargs)

    def _add_history(self, module, args):
        query = args[0]
        if self._prev is None:
            prev = torch.zeros_like(query)
            keep = torch.zeros(query.shape[0], dtype=torch.bool,
                               device=query.device)
        else:
            prev, keep = self._prev, self._scene == self._prev_scene
        return (query + self.history(prev, keep).to(query.dtype),) + args[1:]

    def _keep_bev(self, module, args, out):
        self._prev, self._prev_scene = out[0].detach(), self._scene


class Reference(SceneState, _Reference):
    """The reference's twin."""


def port_class():
    """The port's tiny stateful detector (imports the port)."""
    from unibev_tpu_torch.models.detectors.unibev import UniBEV

    class Port(SceneState, UniBEV):
        pass
    return Port
