"""Seeded random initialization of a whole model, from an explicit generator.

Modules are built without touching torch's global RNG (see
``flagship.build_model``) and then filled here, so a model is a function of
its config and seed alone.  The scheme follows the JAX package's flax
initializers where they give a working network (fan-in normal for convs and
linears, He normal for the sparse convs, unit normal for embeddings, identity
BN, frozen or not); where flax starts
from zeros (the DCN offset conv, the MSDA offset and weight projections) a
small random weight is used instead, so random-weight runs sample at
fractional, query-dependent positions.
"""

from __future__ import annotations

import torch
from torch import nn

from unibev_tpu_torch.models.attention.deformable import (_SamplingHeads,
                                                          grid_offset_bias)
from unibev_tpu_torch.models.attention.temporal import TemporalSelfAttention
from unibev_tpu_torch.models.backbones.resnet import (DeformConv2d,
                                                      FrozenBatchNorm)
from unibev_tpu_torch.models.layers import _InProjAttention
from unibev_tpu_torch.models.middle_encoder import SparseConv3d

_SMALL = {"conv_offset": 0.1, "sampling_offsets": 0.01, "attention_weights": 0.01}
# free parameters whose flax initializer is not the unit normal
_FREE_STD = {"modal_embbeding_C": 0.02, "modal_embbeding_L": 0.02}


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter and buffer of ``model`` from ``generator``."""

    def normal_(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                            dtype=torch.float32) * std)

    for name, m in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, FrozenBatchNorm):
            m.weight.fill_(1.0)
            m.running_var.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.num_batches_tracked.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 1.0)
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            normal_(m.weight, _SMALL.get(leaf, 1.0) * fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.ConvTranspose2d):
            # each output pixel sees Cin inputs on kh * kw / (sh * sw) taps
            cin, _, kh, kw = m.weight.shape
            fan_in = cin * kh * kw / (m.stride[0] * m.stride[1])
            normal_(m.weight, fan_in ** -0.5)
        elif isinstance(m, SparseConv3d):
            normal_(m.weight, (2.0 / m.weight[..., 0].numel()) ** 0.5)
        elif isinstance(m, DeformConv2d):
            normal_(m.weight, (2.0 / m.weight[0].numel()) ** 0.5)
        elif isinstance(m, _InProjAttention):
            normal_(m.in_proj_weight, m.in_proj_weight.shape[1] ** -0.5)
            m.in_proj_bias.zero_()
        else:
            # free parameters: camera / level embeddings, CNW and spatial
            # weights, the fixed modal embeddings
            for pname, p in m.named_parameters(recurse=False):
                normal_(p, _FREE_STD.get(pname, 1.0))
    # after the pass above, which zeroed every Linear bias; the temporal
    # attention's grid spans its queue's levels (heads x (levels x queue) x
    # points x 2), as the published TemporalSelfAttention.init_weights
    for m in model.modules():
        if isinstance(m, _SamplingHeads):
            m.sampling_offsets.bias.copy_(grid_offset_bias(
                m.num_heads, m.num_levels, m.num_points))
        elif isinstance(m, TemporalSelfAttention):
            m.sampling_offsets.bias.copy_(grid_offset_bias(
                m.num_heads, m.num_levels * m.num_bev_queue, m.num_points))
