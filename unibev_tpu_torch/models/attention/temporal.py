"""BEVFormer's temporal self-attention (TSA): each BEV query attends into a
queue of two BEV maps, the previous frame's (aligned with the ego's motion)
and the current queries, and the two results are averaged.

Written from the published ``temporal_self_attention.py``
(fundamentalvision/BEVFormer, ``projects/mmdet3d_plugin/bevformer/
modules``), batch first.  The sampling offsets and attention weights come
from ``cat([prev_bev, query + query_pos])`` (Linear 2C -> queue x heads x
levels x points x 2, and 2C -> queue x heads x levels x points), the
weights softmaxed over levels x points for each queue entry; one MSDA call
(kernel K1 on CUDA) samples both maps at batch 2B from the hybrid
reference points; the queue's mean goes through ``output_proj`` and is
added to the query.  A sample without history attends into ``[query,
query]``, its own layer input twice, as the published layer does when it
is given no previous map.  Which samples have history is a (B,) bool
tensor on the device: the choice is made per sample by ``torch.where``,
with no host read.

Noted departure: the published layer forms the offsets' input from
``value[:bs]`` of the interleaved queue ``[b0 prev, b0 cur, b1 prev, ...]``,
which for B > 1 reads another sample's rows; here each sample takes its own
previous map.  At B = 1 the two are the same.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from unibev_tpu_torch.models.layers import dropout
from unibev_tpu_torch.ops.msda import ms_deform_attn
from unibev_tpu_torch.registry import ATTENTION
from unibev_tpu_torch.utils.timer import spanned


@ATTENTION.register_module(name="TemporalSelfAttention")
class TemporalSelfAttention(nn.Module):
    """``attentions.0`` of a BEVFormer encoder layer."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4,
                 num_bev_queue: int = 2):
        super().__init__()
        if embed_dims % num_heads:
            raise ValueError(f"embed_dims {embed_dims} not divisible by "
                             f"{num_heads}")
        if num_bev_queue != 2:
            raise ValueError("the BEV queue holds the previous and the "
                             "current map: num_bev_queue must be 2")
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.num_bev_queue = num_bev_queue
        n = num_bev_queue * num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dims * num_bev_queue, n * 2)
        self.attention_weights = nn.Linear(embed_dims * num_bev_queue, n)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    @spanned("temporal_attention")
    def forward(self, query: torch.Tensor, query_pos: torch.Tensor,
                prev_bev: torch.Tensor, cur_bev: torch.Tensor,
                history: torch.Tensor, reference_points: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query, query_pos, prev_bev (the aligned previous map), cur_bev
        (the encoder's first queries) (B, Q, C); history (B,) bool;
        reference_points (2B, Q, levels, 2), the queue's [prev, cur] of
        each sample in turn.  Returns (B, Q, C)."""
        B, Q, C = query.shape
        h, L, P, T = (self.num_heads, self.num_levels, self.num_points,
                      self.num_bev_queue)
        keep = history[:, None, None]
        prev = torch.where(keep, prev_bev, query)
        cur = torch.where(keep, cur_bev, query)
        value = torch.stack([prev, cur], 1).reshape(B * T, Q, C)
        mixed = torch.cat([prev, query + query_pos], -1)
        v = self.value_proj(value).view(B * T, Q, h, C // h)
        offsets = self.sampling_offsets(mixed).view(
            B, Q, h, T, L, P, 2).float()
        # offsets are (x, y) in cells: divide by each level's (W, H)
        for lvl, (H, W) in enumerate(spatial_shapes):
            offsets[..., lvl, :, 0].div_(W)
            offsets[..., lvl, :, 1].div_(H)
        weights = self.attention_weights(mixed).view(B, Q, h, T, L * P)
        weights = torch.softmax(weights, dim=-1).view(B, Q, h, T, L, P)
        offsets = offsets.permute(0, 3, 1, 2, 4, 5, 6).reshape(
            B * T, Q, h, L, P, 2)
        weights = weights.permute(0, 3, 1, 2, 4, 5).reshape(B * T, Q, h, L, P)
        loc = reference_points.float()[:, :, None, :, None, :] + offsets
        out = ms_deform_attn(v.contiguous(), spatial_shapes, loc.contiguous(),
                             weights.to(v.dtype).contiguous())
        out = out.view(B, T, Q, C).mean(1)
        return query + dropout(self.output_proj(out), self.training)
