"""Common building blocks: FFN, MultiheadAttention, LearnedPositionalEncoding.

Counterpart of ``unibev_tpu/models/layers.py``.  Module attribute names follow
the reference's mmcv bricks, so ``state_dict`` keys are the reference's:
``ffns.0.layers.0.0`` / ``ffns.0.layers.1`` for the FFN and
``attn.in_proj_weight`` / ``attn.out_proj`` for MultiheadAttention.
Inference only: dropout is the identity and is left out.
"""

from __future__ import annotations

import torch
from torch import nn

from unibev_tpu_torch.registry import POSITIONAL_ENCODINGS

# flax's LayerNorm epsilon, which every LayerNorm of the JAX package uses.
LN_EPS = 1e-6


def layer_norm(dims: int) -> nn.LayerNorm:
    return nn.LayerNorm(dims, eps=LN_EPS)


class FFN(nn.Module):
    """Transformer feed-forward block with residual add."""

    def __init__(self, embed_dims: int, feedforward_channels: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dims, feedforward_channels),
                          nn.ReLU(inplace=True)),
            nn.Linear(feedforward_channels, embed_dims))

    def forward(self, x, identity=None):
        return (x if identity is None else identity) + self.layers(x)


class _InProjAttention(nn.Module):
    """Holds the packed q/k/v projection under torch's MultiheadAttention names."""

    def __init__(self, embed_dims: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims, embed_dims))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dims))
        self.out_proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, query, key, value):
        B, Nq, C = query.shape
        h = self.num_heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(x, w, b):
            return nn.functional.linear(x, w, b).view(B, -1, h, C // h).transpose(1, 2)

        q = heads(query, wq, bq) * (C // h) ** -0.5
        k = heads(key, wk, bk)
        v = heads(value, wv, bv)
        attn = torch.softmax(q @ k.transpose(-2, -1), dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(B, Nq, C)
        return self.out_proj(out)


class MultiheadAttention(nn.Module):
    """Standard MHA with residual, (B, N, C) layout (decoder self-attention)."""

    def __init__(self, embed_dims: int, num_heads: int = 8):
        super().__init__()
        self.attn = _InProjAttention(embed_dims, num_heads)

    def forward(self, query, key=None, value=None, identity=None,
                query_pos=None, key_pos=None):
        key = query if key is None else key
        value = key if value is None else value
        identity = query if identity is None else identity
        if query_pos is not None:
            query = query + query_pos
        if key_pos is not None:
            key = key + key_pos
        return identity + self.attn(query, key, value)


@POSITIONAL_ENCODINGS.register_module()
class LearnedPositionalEncoding(nn.Module):
    """Learned row/col embeddings -> (B, H*W, 2*num_feats) BEV positional map."""

    def __init__(self, num_feats: int, row_num_embed: int = 50,
                 col_num_embed: int = 50):
        super().__init__()
        self.num_feats = num_feats
        self.row_embed = nn.Embedding(row_num_embed, num_feats)
        self.col_embed = nn.Embedding(col_num_embed, num_feats)

    def forward(self, batch: int, h: int, w: int) -> torch.Tensor:
        row = self.row_embed.weight[:h]                        # (h, F)
        col = self.col_embed.weight[:w]                        # (w, F)
        pos = torch.cat([col[None, :, :].expand(h, w, -1),
                         row[:, None, :].expand(h, w, -1)], dim=-1)
        return pos.reshape(1, h * w, -1).expand(batch, -1, -1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))
