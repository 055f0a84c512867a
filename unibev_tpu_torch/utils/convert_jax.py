"""JAX variables -> the port's ``state_dict``.

The inverse of ``unibev_tpu/utils/convert_torch.py::convert_state_dict``,
restricted to the camera-only slice: ResNet (+DCNv2), FPN, the head and the
transformer's camera encoder and decoder.  Input is the JAX model's variables
as numpy arrays (``params``, plus ``constants`` for the frozen BN); the
output carries the reference checkpoint's key names, which are the port's.
Layouts converted back:

  * conv kernel (Kh, Kw, Cin, Cout)        -> (Cout, Cin, Kh, Kw)
  * Dense kernel (Cin, Cout)               -> Linear weight (Cout, Cin)
  * DCN weight (Kh*Kw*Cin, Cout) tap-major -> (Cout, Cin, Kh, Kw), Kh = Kw = 3
  * flax MHA query/key/value/out           -> in_proj_weight/in_proj_bias/out_proj
  * frozen BN constants gamma/beta/mean/var -> weight/bias/running_mean/running_var
    (+ num_batches_tracked = 0)

A variable this slice has no key for raises ``KeyError``.  Imports no JAX.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

_BN = {"gamma": "weight", "beta": "bias", "mean": "running_mean",
       "var": "running_var"}
_WB = {"kernel": "weight", "bias": "bias", "scale": "weight"}


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _conv(w):
    return np.transpose(w, (3, 2, 0, 1))


def _dense(kind, w):
    return (np.transpose(w) if kind == "kernel" else w)


def _dcn(w):
    kcin, cout = w.shape
    return np.transpose(w.reshape(3, 3, kcin // 9, cout), (3, 2, 0, 1))


def _bn(prefix, name, w):
    out = [(f"{prefix}.{_BN[name]}", w)]
    if name == "gamma":
        out.append((f"{prefix}.num_batches_tracked", np.asarray(0, np.int64)))
    return out


def _resnet(m, w) -> List:
    s, b, rest = m.group(1), m.group(2), m.group(3)
    p = f"img_backbone.layer{s}.{b}"
    if r := re.fullmatch(r"(conv[123])/kernel", rest):
        return [(f"{p}.{r.group(1)}.weight", _conv(w))]
    if rest == "conv2/weight":
        return [(f"{p}.conv2.weight", _dcn(w))]
    if r := re.fullmatch(r"conv2/conv_offset/(kernel|bias)", rest):
        kind = r.group(1)
        return [(f"{p}.conv2.conv_offset.{_WB[kind]}",
                 _conv(w) if kind == "kernel" else w)]
    if r := re.fullmatch(r"(bn[123])/(\w+)", rest):
        return _bn(f"{p}.{r.group(1)}", r.group(2), w)
    if rest == "downsample_conv/kernel":
        return [(f"{p}.downsample.0.weight", _conv(w))]
    if r := re.fullmatch(r"downsample_bn/(\w+)", rest):
        return _bn(f"{p}.downsample.1", r.group(1), w)
    return None


def _attn_ffn_norm(prefix: str, rest: str, w, cross: str):
    """Encoder / decoder layer sub-keys shared by both; ``cross`` names the
    attentions.1 sub-path (``deformable_attention.`` for the SCA's inner MSDA)."""
    if r := re.fullmatch(r"self_attn/(sampling_offsets|attention_weights|"
                         r"value_proj|output_proj)/(kernel|bias)", rest):
        return [(f"{prefix}.attentions.0.{r.group(1)}.{_WB[r.group(2)]}",
                 _dense(r.group(2), w))]
    if r := re.fullmatch(r"cross_attn/(?:deformable_attention/)?(sampling_offsets|"
                         r"attention_weights|value_proj)/(kernel|bias)", rest):
        return [(f"{prefix}.attentions.1.{cross}{r.group(1)}.{_WB[r.group(2)]}",
                 _dense(r.group(2), w))]
    if r := re.fullmatch(r"cross_attn/output_proj/(kernel|bias)", rest):
        return [(f"{prefix}.attentions.1.output_proj.{_WB[r.group(1)]}",
                 _dense(r.group(1), w))]
    if r := re.fullmatch(r"ffn/fc([01])/(kernel|bias)", rest):
        sub = "layers.0.0" if r.group(1) == "0" else "layers.1"
        return [(f"{prefix}.ffns.0.{sub}.{_WB[r.group(2)]}", _dense(r.group(2), w))]
    if r := re.fullmatch(r"norm([123])/(scale|bias)", rest):
        return [(f"{prefix}.norms.{int(r.group(1)) - 1}.{_WB[r.group(2)]}", w)]
    return None


def _encoder(m, w):
    prefix = f"pts_bbox_head.transformer.img_bev_encoder.layers.{m.group(1)}"
    return _attn_ffn_norm(prefix, m.group(2), w, "deformable_attention.")


def _decoder(m, w):
    prefix = f"pts_bbox_head.transformer.decoder.layers.{m.group(1)}"
    rest = m.group(2)
    if r := re.fullmatch(r"self_attn/attn/(query|key|value)/(kernel|bias)", rest):
        # collected per layer and packed into in_proj_* by jax_to_state_dict
        return [(("in_proj", prefix, r.group(2), r.group(1)), w)]
    if r := re.fullmatch(r"self_attn/attn/out/(kernel|bias)", rest):
        if r.group(1) == "kernel":
            return [(f"{prefix}.attentions.0.attn.out_proj.weight",
                     w.reshape(-1, w.shape[-1]).T)]
        return [(f"{prefix}.attentions.0.attn.out_proj.bias", w)]
    if rest.startswith("self_attn/"):
        return None
    return _attn_ffn_norm(prefix, rest, w, "")


def _branch(m, w):
    kind, layer, sub, wb = m.group(1), m.group(2), m.group(3), m.group(4)
    step = 3 if kind == "cls" else 2
    if sub == "out":
        idx = 2 * step
    elif sub.startswith("fc"):
        idx = step * int(sub[2:])
    elif kind == "cls" and sub.startswith("ln"):
        idx = step * int(sub[2:]) + 1
    else:
        return None
    return [(f"pts_bbox_head.{kind}_branches.{layer}.{idx}.{_WB[wb]}",
             _dense(wb, w))]


_H = "pts_bbox_head"
_T = f"{_H}/transformer"
_RULES: List[Tuple[str, Callable]] = [
    (r"img_backbone/conv1/kernel",
     lambda m, w: [("img_backbone.conv1.weight", _conv(w))]),
    (r"img_backbone/bn1/(\w+)", lambda m, w: _bn("img_backbone.bn1", m.group(1), w)),
    (r"img_backbone/layer(\d+)_(\d+)/(.+)", _resnet),
    (r"img_neck/(lateral|fpn)(\d+)/(kernel|bias)",
     lambda m, w: [(f"img_neck.{m.group(1)}_convs.{m.group(2)}.conv.{_WB[m.group(3)]}",
                 _conv(w) if m.group(3) == "kernel" else w)]),
    (rf"{_H}/(bev_embedding|query_embedding)",
     lambda m, w: [(f"pts_bbox_head.{m.group(1)}.weight", w)]),
    (rf"{_H}/positional_encoding/(row|col)_embed/embedding",
     lambda m, w: [(f"pts_bbox_head.positional_encoding.{m.group(1)}_embed.weight", w)]),
    (rf"{_H}/(cls|reg)_branch(\d+)/(\w+)/(kernel|bias|scale)", _branch),
    (rf"{_T}/(img_channel_weights|pts_channel_weights|cams_embeds|img_level_embeds)",
     lambda m, w: [(f"pts_bbox_head.transformer.{m.group(1)}", w)]),
    (rf"{_T}/reference_points/(kernel|bias)",
     lambda m, w: [(f"pts_bbox_head.transformer.reference_points.{_WB[m.group(1)]}",
                 _dense(m.group(1), w))]),
    (rf"{_T}/img_encoder/layer(\d+)/(.+)", _encoder),
    (rf"{_T}/decoder/layer(\d+)/(.+)", _decoder),
]


def _pack_in_proj(parts: Dict) -> Dict[str, np.ndarray]:
    out = {}
    for (prefix, kind), qkv in parts.items():
        ws = [qkv[n] for n in ("query", "key", "value")]
        if kind == "kernel":     # (C, heads, head_dim) -> (C_out, C_in) rows
            packed = np.concatenate([w.reshape(w.shape[0], -1).T for w in ws], 0)
            out[f"{prefix}.attentions.0.attn.in_proj_weight"] = packed
        else:                    # (heads, head_dim)
            out[f"{prefix}.attentions.0.attn.in_proj_bias"] = np.concatenate(
                [w.reshape(-1) for w in ws])
    return out


def jax_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """The port's state_dict from the JAX camera-only UniBEV's variables."""
    out: Dict[str, np.ndarray] = {}
    in_proj: Dict = {}
    unknown = []
    for col in ("params", "constants"):
        for path, w in _flatten(variables.get(col, {})):
            joined = "/".join(path)
            items = None
            for pattern, handler in _RULES:
                if m := re.fullmatch(pattern, joined):
                    items = handler(m, w)
                    break
            if items is None:
                unknown.append(f"{col}/{joined}")
                continue
            for key, val in items:
                if isinstance(key, tuple):           # ("in_proj", prefix, kind, name)
                    in_proj.setdefault((key[1], key[2]), {})[key[3]] = val
                else:
                    out[key] = val
    if unknown:
        raise KeyError(f"no port key for JAX variables: {unknown}")
    out.update(_pack_in_proj(in_proj))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}
