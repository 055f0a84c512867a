"""DETR3D-style object decoder with iterative box refinement.

Counterpart of ``unibev_tpu/models/decoder.py``.  Per layer: MHA self-
attention over the object queries, CustomMSDeformableAttention into the fused
BEV map at the xy of the (sigmoid-space) reference points, FFN; then the
layer's reg branch refines xy (dims 0:2) and z (reg dim 4 -> ref dim 2) in
inverse-sigmoid space, re-sigmoids and detaches (the JAX package's
stop_gradient).  Dropout sits in the MHA, the cross-attention and the FFN.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from benchmark.reference.models.attention.deformable import \
    CustomMSDeformableAttention
from benchmark.reference.models.layers import (FFN, MultiheadAttention,
                                            inverse_sigmoid, layer_norm)
from benchmark.reference.registry import TRANSFORMER_LAYER_SEQUENCES


class DecoderLayer(nn.Module):
    """MHA -> LN -> MSDA -> LN -> FFN -> LN, under the reference's names
    (``attentions.0``, ``attentions.1``, ``ffns.0``, ``norms.0-2``)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 ffn_dims: int = 512, cross_attn_cfg: Optional[dict] = None):
        super().__init__()
        ca = {k: v for k, v in dict(cross_attn_cfg or {}).items() if k != "type"}
        ca.setdefault("embed_dims", embed_dims)
        self.attentions = nn.ModuleList([
            MultiheadAttention(embed_dims, num_heads),
            CustomMSDeformableAttention(**ca)])
        self.ffns = nn.ModuleList([FFN(embed_dims, ffn_dims)])
        self.norms = nn.ModuleList([layer_norm(embed_dims) for _ in range(3)])

    def forward(self, query, value, query_pos, reference_points_2d, value_shapes):
        query = self.attentions[0](query, query_pos=query_pos, key_pos=query_pos)
        query = self.norms[0](query)
        query = self.attentions[1](query, value, reference_points_2d,
                                   value_shapes, query_pos=query_pos)
        query = self.norms[1](query)
        query = self.ffns[0](query)
        return self.norms[2](query)


@TRANSFORMER_LAYER_SEQUENCES.register_module(name="DetectionTransformerDecoder")
class DetectionTransformerDecoder(nn.Module):

    def __init__(self, num_layers: int = 6, embed_dims: int = 256,
                 num_heads: int = 8, ffn_dims: int = 512,
                 cross_attn_cfg: Optional[dict] = None):
        super().__init__()
        self.layers = nn.ModuleList([
            DecoderLayer(embed_dims, num_heads, ffn_dims, cross_attn_cfg)
            for _ in range(num_layers)])

    def forward(self, query, value, query_pos, reference_points, value_shapes,
                reg_branches: Optional[Sequence[Callable]] = None):
        """query (B, Nq, C); value (B, V, C); reference_points (B, Nq, 3) in
        sigmoid space; reg_branches[l] maps (B, Nq, C) -> (B, Nq, 10).

        Returns (states (L, B, Nq, C), refs (L, B, Nq, 3)), refs[l] being the
        reference points layer l used (before its refinement).
        """
        states, refs = [], []
        for lid, layer in enumerate(self.layers):
            refs.append(reference_points)
            query = layer(query, value, query_pos,
                          reference_points[..., None, :2], value_shapes)
            states.append(query)
            if reg_branches is not None:
                tmp = reg_branches[lid](query)
                xy = tmp[..., 0:2] + inverse_sigmoid(reference_points[..., 0:2])
                z = tmp[..., 4:5] + inverse_sigmoid(reference_points[..., 2:3])
                reference_points = torch.sigmoid(
                    torch.cat([xy, z], dim=-1)).detach()
        return torch.stack(states), torch.stack(refs)
