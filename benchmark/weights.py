"""Seeded random weights, made on the device in a few large calls.

The scheme is the port's random initialization (fan-in normal for convs
and linears, He normal for the sparse and deformable convs, unit normal
for embeddings and free parameters, identity norms, small offset and
attention-weight projections, Deformable-DETR's grid bias of the sampling
offsets), decided here from the plain reference's modules, so that one
state dict, keyed as both models key theirs, loads into the port and into
the reference.  All normal draws come from one ``torch.randn`` on the
device, cut into each tensor and scaled; the values are then cast to the
type the model is served in.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from benchmark.reference.models.attention.deformable import (_SamplingHeads,
                                                             grid_offset_bias)
from benchmark.reference.models.backbones.resnet import (DeformConv2d,
                                                         FrozenBatchNorm)
from benchmark.reference.models.layers import _InProjAttention
from benchmark.reference.models.middle_encoder import SparseConv3d

SMALL = {"conv_offset": 0.1, "sampling_offsets": 0.01,
         "attention_weights": 0.01}
FREE_STD = {"modal_embbeding_C": 0.02, "modal_embbeding_L": 0.02}
NORM_VALUES = {"weight": 1.0, "bias": 0.0, "running_mean": 0.0,
               "running_var": 1.0, "num_batches_tracked": 0}


def _rules(model: nn.Module) -> Dict[str, Tuple[str, object]]:
    """{state-dict key: ("normal", std) | ("const", value) | ("tensor", t)}
    for every entry of ``model``'s state dict."""
    rules: Dict[str, Tuple[str, object]] = {}
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        leaf = name.rsplit(".", 1)[-1]
        own = dict(m.named_parameters(recurse=False))
        own.update(m.named_buffers(recurse=False))
        if isinstance(m, (nn.LayerNorm, FrozenBatchNorm,
                          nn.modules.batchnorm._BatchNorm)):
            for k in own:
                rules[prefix + k] = ("const", NORM_VALUES[k])
        elif isinstance(m, nn.Embedding):
            rules[prefix + "weight"] = ("normal", 1.0)
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            rules[prefix + "weight"] = ("normal",
                                        SMALL.get(leaf, 1.0) * fan_in ** -0.5)
            if m.bias is not None:
                rules[prefix + "bias"] = ("const", 0.0)
        elif isinstance(m, nn.ConvTranspose2d):
            cin, _, kh, kw = m.weight.shape
            fan_in = cin * kh * kw / (m.stride[0] * m.stride[1])
            rules[prefix + "weight"] = ("normal", fan_in ** -0.5)
        elif isinstance(m, SparseConv3d):
            rules[prefix + "weight"] = (
                "normal", (2.0 / m.weight[..., 0].numel()) ** 0.5)
        elif isinstance(m, DeformConv2d):
            rules[prefix + "weight"] = ("normal",
                                        (2.0 / m.weight[0].numel()) ** 0.5)
        elif isinstance(m, _InProjAttention):
            rules[prefix + "in_proj_weight"] = (
                "normal", m.in_proj_weight.shape[1] ** -0.5)
            rules[prefix + "in_proj_bias"] = ("const", 0.0)
        else:
            for k in own:
                rules[prefix + k] = ("normal", FREE_STD.get(k, 1.0))
        if isinstance(m, _SamplingHeads):
            rules[prefix + "sampling_offsets.bias"] = ("tensor", grid_offset_bias(
                m.num_heads, m.num_levels, m.num_points))
    return rules


@torch.no_grad()
def make_state(model: nn.Module, seed: int, device, dtype: torch.dtype
               ) -> Dict[str, torch.Tensor]:
    """The state dict of ``model`` (the reference, on any device, meta
    included) drawn from ``seed`` on ``device``: floating entries in
    ``dtype``, integer ones as they are."""
    shapes = {k: (tuple(v.shape), v.dtype)
              for k, v in model.state_dict().items()}
    rules = _rules(model)
    missing = sorted(set(shapes) - set(rules))
    if missing:
        raise KeyError(f"no initialization rule for {missing[:5]}")
    normal: List[Tuple[str, float, int]] = [
        (k, rules[k][1], torch.Size(shapes[k][0]).numel())
        for k in shapes if rules[k][0] == "normal"]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(n for _, _, n in normal), generator=gen,
                       device=device, dtype=torch.float32)
    state: Dict[str, torch.Tensor] = {}
    offset = 0
    for k, std, n in normal:
        state[k] = (flat[offset:offset + n].view(shapes[k][0]) * std).to(dtype)
        offset += n
    del flat
    for k, (shape, kind) in shapes.items():
        rule, value = rules[k]
        target = dtype if kind.is_floating_point else kind
        if rule == "const":
            state[k] = torch.full(shape, value, dtype=target, device=device)
        elif rule == "tensor":
            state[k] = value.reshape(shape).to(device=device, dtype=target)
    return {k: state[k] for k in shapes}
