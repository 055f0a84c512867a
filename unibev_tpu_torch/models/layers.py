"""Common building blocks: FFN, MultiheadAttention, LearnedPositionalEncoding,
flax's BatchNorm, and dropout drawn from an explicit generator.

Counterpart of ``unibev_tpu/models/layers.py``.  Module attribute names follow
the reference's mmcv bricks, so ``state_dict`` keys are the reference's:
``ffns.0.layers.0.0`` / ``ffns.0.layers.1`` for the FFN and
``attn.in_proj_weight`` / ``attn.out_proj`` for MultiheadAttention.

Dropout runs at the JAX package's sites, only in ``train()`` mode, and draws
from the generator that :func:`rng` installs around a forward (the
detector's ``forward(batch, generator)`` does); a train-mode forward without
one raises.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch import nn

from unibev_tpu_torch.parallel.dist import get_world_size, sum_over_ranks
from unibev_tpu_torch.registry import POSITIONAL_ENCODINGS

# flax's LayerNorm epsilon, which every LayerNorm of the JAX package uses.
LN_EPS = 1e-6
# the dropout rate of every site on the camera path (the configs' 0.1)
DROPOUT = 0.1

_generator: contextvars.ContextVar = contextvars.ContextVar(
    "unibev_dropout_generator", default=None)


@contextlib.contextmanager
def rng(generator):
    """Draw the dropout masks of the forwards inside from ``generator``."""
    token = _generator.set(generator)
    try:
        yield
    finally:
        _generator.reset(token)


def dropout(x: torch.Tensor, training: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: zero with probability :data:`DROPOUT`, scale the
    rest by 1 / (1 - DROPOUT); the identity outside training."""
    if not training:
        return x
    gen = _generator.get()
    if gen is None:
        raise RuntimeError("train-mode dropout needs a generator: run the "
                           "forward inside layers.rng(generator)")
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= DROPOUT
    return x * keep.to(x.dtype) / (1.0 - DROPOUT)


def layer_norm(dims: int) -> nn.LayerNorm:
    return nn.LayerNorm(dims, eps=LN_EPS)


class BatchNorm2d(nn.BatchNorm2d):
    """flax ``BatchNorm`` (the LiDAR backbone's and neck's) under torch's
    names.  Eval: ``nn.BatchNorm2d``.  Train: normalize with the batch's
    mean and biased variance, as torch does, and move the running
    statistics by ``(1 - momentum) * running + momentum * batch`` with the
    *biased* variance, as flax does; ``nn.BatchNorm2d`` would use the
    unbiased one, n / (n - 1) larger.  The ``state_dict`` keys are
    ``nn.BatchNorm2d``'s.

    Under a process group of more than one rank (data parallel) the batch
    statistics are those of the global batch, as the JAX mesh computes
    them: the per-channel sums and counts, then the squared deviations, are
    summed over the ranks (differentiably), so every rank normalizes alike
    and keeps the same running statistics.  At one rank the batch's own
    statistics are the global ones, and cuDNN's batch_norm runs: the
    elementwise path costs ~2.5 ms more device time a flagship LC train
    step on an H100 (PERF.md section 6)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if get_world_size() > 1:
            return self._synced(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       unbiased=False)
            for running, batch in ((self.running_mean, mean),
                                   (self.running_var, var)):
                running.mul_(1 - self.momentum).add_(self.momentum * batch)
            self.num_batches_tracked += 1
        return nn.functional.batch_norm(x, None, None, self.weight, self.bias,
                                        True, 0.0, self.eps)

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        count = torch.full((1,), x.numel() / x.shape[1], device=x.device)
        s = sum_over_ranks(torch.cat([xf.sum((0, 2, 3)), count]))
        mean = s[:-1] / s[-1]
        dev = xf - mean[None, :, None, None]
        var = sum_over_ranks((dev * dev).sum((0, 2, 3))) / s[-1]
        with torch.no_grad():
            for running, batch in ((self.running_mean, mean),
                                   (self.running_var, var)):
                running.mul_(1 - self.momentum).add_(self.momentum * batch)
            self.num_batches_tracked += 1
        scale = self.weight.float() * torch.rsqrt(var + self.eps)
        bias = self.bias.float()
        out = dev * scale[None, :, None, None] + bias[None, :, None, None]
        return out.to(x.dtype)


class FFN(nn.Module):
    """Transformer feed-forward block with residual add; dropout after the
    activation and after the output projection."""

    def __init__(self, embed_dims: int, feedforward_channels: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dims, feedforward_channels),
                          nn.ReLU(inplace=True)),
            nn.Linear(feedforward_channels, embed_dims))

    def forward(self, x, identity=None):
        hidden = dropout(self.layers[0](x), self.training)
        out = dropout(self.layers[1](hidden), self.training)
        return (x if identity is None else identity) + out


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
    """Standard MHA with dropout and residual, (B, N, C) layout (decoder
    self-attention)."""

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
        return identity + dropout(self.attn(query, key, value), self.training)


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
