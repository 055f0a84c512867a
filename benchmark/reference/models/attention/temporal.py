"""BEVFormer's temporal self-attention, written from the published
``temporal_self_attention.py`` (fundamentalvision/BEVFormer,
``projects/mmdet3d_plugin/bevformer/modules``), batch first, float32, the
sampling by ``grid_sample`` (``ops/msda.py``).

The value is the queue ``[prev_bev, query]`` of each sample, interleaved
over the batch (2B maps); without one, ``[query, query]``.  Offsets and
weights come from ``cat([prev, query + query_pos])``; the weights are
softmaxed over levels x points for each queue entry; the two maps'
results are averaged, projected and added to the query.

Noted departure: the published layer takes the offsets' input map as
``value[:bs]``, which for B > 1 reads the interleaved queue's rows of
another sample; here each sample takes its own previous map
(``value.view(bs, 2, ...)[:, 0]``).  At B = 1 the two are the same.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from benchmark.reference.ops.msda import ms_deform_attn


class TemporalSelfAttention(nn.Module):

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4,
                 num_bev_queue: int = 2):
        super().__init__()
        assert num_bev_queue == 2
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.num_bev_queue = num_bev_queue
        self.sampling_offsets = nn.Linear(
            embed_dims * num_bev_queue,
            num_bev_queue * num_heads * num_levels * num_points * 2)
        self.attention_weights = nn.Linear(
            embed_dims * num_bev_queue,
            num_bev_queue * num_heads * num_levels * num_points)
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.output_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query: torch.Tensor, value: Optional[torch.Tensor],
                query_pos: torch.Tensor, reference_points: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query, query_pos (bs, Q, C); value (bs * 2, Q, C), the queue, or
        None; reference_points (bs * 2, Q, levels, 2)."""
        if value is None:
            bs, len_bev, c = query.shape
            value = torch.stack([query, query], 1).reshape(bs * 2, len_bev, c)
        identity = query
        query = query + query_pos
        bs, num_query, embed_dims = query.shape
        _, num_value, _ = value.shape
        heads, L, P = self.num_heads, self.num_levels, self.num_points
        T = self.num_bev_queue
        prev = value.view(bs, T, num_value, embed_dims)[:, 0]
        query = torch.cat([prev, query], -1)
        value = self.value_proj(value).reshape(bs * T, num_value, heads, -1)
        sampling_offsets = self.sampling_offsets(query).view(
            bs, num_query, heads, T, L, P, 2)
        attention_weights = self.attention_weights(query).view(
            bs, num_query, heads, T, L * P).softmax(-1)
        attention_weights = attention_weights.view(bs, num_query, heads, T,
                                                   L, P)
        attention_weights = attention_weights.permute(0, 3, 1, 2, 4, 5) \
            .reshape(bs * T, num_query, heads, L, P).contiguous()
        sampling_offsets = sampling_offsets.permute(0, 3, 1, 2, 4, 5, 6) \
            .reshape(bs * T, num_query, heads, L, P, 2)
        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                  dtype=sampling_offsets.dtype,
                                  device=sampling_offsets.device)
        sampling_locations = reference_points[:, :, None, :, None, :] \
            + sampling_offsets / normalizer[None, None, None, :, None, :]
        output = ms_deform_attn(value, spatial_shapes, sampling_locations,
                                attention_weights)
        # (bs * 2, Q, C) -> (Q, C, bs, 2): the queue's mean
        output = output.permute(1, 2, 0).reshape(num_query, embed_dims, bs, T)
        output = output.mean(-1).permute(2, 0, 1)
        return self.output_proj(output) + identity
