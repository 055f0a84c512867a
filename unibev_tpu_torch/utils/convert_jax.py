"""JAX variables -> the port's ``state_dict``.

The inverse of ``unibev_tpu/utils/convert_torch.py::convert_state_dict`` for
the LC model: ResNet (+DCNv2), FPN, the sparse middle encoder, SECOND,
SECONDFPN, the head and the transformer's camera and LiDAR encoders and
decoder.  Input is the JAX model's variables as numpy arrays (``params``,
``constants`` for the frozen BN, ``batch_stats`` for the LiDAR branch's BN);
the output carries the reference checkpoint's key names, which are the
port's.  That covers every fusion option of the transformer:
``channel_weights_proj.0`` (MLP-CNW), ``modal_embbeding_mlp.0`` / ``.2`` and
``modal_embbeding_C`` / ``_L`` (the reference's spelling; the JAX package's
``modal_embed_fc1`` / ``fc2`` and ``modal_embedding_C`` / ``_L``),
``img_spatial_weights`` / ``pts_spatial_weights``, and with dual queries
the reference's ``bev_embedding_img`` / ``bev_embedding_pts``, the column
halves of the JAX package's one (HW, 2C) ``bev_embedding``.  The reference
names no ModalityProjection weights: they keep the JAX package's names,
``l_modal_proj`` / ``c_modal_proj``.  The FPN's extra levels land after its
level convs in ``fpn_convs``, as in mmdet.  Layouts converted back:

  * conv kernel (Kh, Kw, Cin, Cout)        -> (Cout, Cin, Kh, Kw)
  * transposed-conv kernel (Kh, Kw, Cin, Cout) -> (Cin, Cout, Kh, Kw), the
    kernel mirrored in both spatial axes: flax's ``ConvTranspose`` applies
    tap ``K - 1 - a`` where torch's ``ConvTranspose2d`` applies tap ``a``
  * Dense kernel (Cin, Cout)               -> Linear weight (Cout, Cin)
  * DCN weight (Kh*Kw*Cin, Cout) tap-major -> (Cout, Cin, Kh, Kw), Kh = Kw = 3
  * sparse conv weight (K*Cin, Cout) tap-major -> spconv's (kz, ky, kx, Cin,
    Cout): (3, 3, 3) for 27 taps, (3, 1, 1) for ``conv_out``'s 3
  * flax MHA query/key/value/out           -> in_proj_weight/in_proj_bias/out_proj
  * frozen BN constants gamma/beta/mean/var -> weight/bias/running_mean/running_var
  * BN params scale/bias and batch_stats mean/var -> weight/bias and
    running_mean/running_var
    (every BN gains num_batches_tracked = 0)

A variable the port has no key for raises ``KeyError``.  Imports no JAX.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

_BN = {"gamma": "weight", "beta": "bias", "mean": "running_mean",
       "var": "running_var", "scale": "weight", "bias": "bias"}
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


def _deconv(w):
    return np.transpose(w[::-1, ::-1], (2, 3, 0, 1))


def _spconv(w, taps):
    kcin, cout = w.shape
    kernel = (3, 3, 3) if taps == 27 else (3, 1, 1)
    return w.reshape(*kernel, kcin // taps, cout)


def _bn(prefix, name, w):
    out = [(f"{prefix}.{_BN[name]}", w)]
    if name in ("gamma", "scale"):
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
    prefix = (f"pts_bbox_head.transformer.{m.group(1)}_bev_encoder.layers."
              f"{m.group(2)}")
    return _attn_ffn_norm(prefix, m.group(3), w, "deformable_attention.")


_ME = "pts_middle_encoder"


def _middle(m, w, n_basic):
    """SparseEncoder variables; ``n_basic[i]`` is stage i's count of basic
    blocks, which puts its strided conv at index n_basic[i]."""
    rest = m.group(1)
    if r := re.fullmatch(r"(conv_input|conv_out)(?:_weight|/weight)", rest):
        taps = 3 if r.group(1) == "conv_out" else 27
        return [(f"{_ME}.{r.group(1)}.0.weight", _spconv(w, taps))]
    if r := re.fullmatch(r"(conv_input|conv_out)(?:_bn|/bn)/(\w+)", rest):
        return _bn(f"{_ME}.{r.group(1)}.1", r.group(2), w)
    if r := re.fullmatch(r"stage(\d+)_block(\d+)/conv(\d)/(weight|bn/(\w+))", rest):
        p = f"{_ME}.encoder_layers.encoder_layer{int(r.group(1)) + 1}.{r.group(2)}"
        if r.group(4) == "weight":
            return [(f"{p}.conv{r.group(3)}.weight", _spconv(w, 27))]
        return _bn(f"{p}.bn{r.group(3)}", r.group(5), w)
    if r := re.fullmatch(r"down(\d+)_(weight|bn/(\w+))", rest):
        i = int(r.group(1))
        p = f"{_ME}.encoder_layers.encoder_layer{i + 1}.{n_basic[i]}"
        if r.group(2) == "weight":
            return [(f"{p}.0.weight", _spconv(w, 27))]
        return _bn(f"{p}.1", r.group(3), w)
    return None


def _second(m, w):
    stage, kind, i, name = m.groups()
    p = f"pts_backbone.blocks.{stage}.{3 * int(i) + (kind == 'bn')}"
    if kind == "conv":
        return [(f"{p}.weight", _conv(w))]
    return _bn(p, name, w)


def _secondfpn(m, w):
    i, kind, name = m.groups()
    if kind == "conv":
        # a (s, s) kernel with s > 1 is the transposed conv, (1, 1) the conv
        return [(f"pts_neck.deblocks.{i}.0.weight",
                 _deconv(w) if w.shape[0] > 1 else _conv(w))]
    return _bn(f"pts_neck.deblocks.{i}.1", name, w)


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
# the transformer's Linears whose port names differ from the JAX ones
_TORCH_NAMES = {"channel_weights_proj": "channel_weights_proj.0",
                "modal_embed_fc1": "modal_embbeding_mlp.0",
                "modal_embed_fc2": "modal_embbeding_mlp.2",
                "l_modal_proj": "l_modal_proj", "c_modal_proj": "c_modal_proj"}
_RULES: List[Tuple[str, Callable]] = [
    (r"img_backbone/conv1/kernel",
     lambda m, w: [("img_backbone.conv1.weight", _conv(w))]),
    (r"img_backbone/bn1/(\w+)", lambda m, w: _bn("img_backbone.bn1", m.group(1), w)),
    (r"img_backbone/layer(\d+)_(\d+)/(.+)", _resnet),
    (r"img_neck/(lateral|fpn)(\d+)/(kernel|bias)",
     lambda m, w: [(f"img_neck.{m.group(1)}_convs.{m.group(2)}.conv.{_WB[m.group(3)]}",
                 _conv(w) if m.group(3) == "kernel" else w)]),
    (rf"{_H}/query_embedding",
     lambda m, w: [("pts_bbox_head.query_embedding.weight", w)]),
    (rf"{_H}/positional_encoding/(row|col)_embed/embedding",
     lambda m, w: [(f"pts_bbox_head.positional_encoding.{m.group(1)}_embed.weight", w)]),
    (rf"{_H}/(cls|reg)_branch(\d+)/(\w+)/(kernel|bias|scale)", _branch),
    (rf"{_T}/(img_channel_weights|pts_channel_weights|cams_embeds|img_level_embeds"
     r"|pts_level_embeds|img_spatial_weights|pts_spatial_weights)",
     lambda m, w: [(f"pts_bbox_head.transformer.{m.group(1)}", w)]),
    (rf"{_T}/modal_embedding_(C|L)",
     lambda m, w: [(f"pts_bbox_head.transformer.modal_embbeding_{m.group(1)}", w)]),
    (rf"{_T}/(channel_weights_proj|modal_embed_fc1|modal_embed_fc2|l_modal_proj"
     r"|c_modal_proj)/(kernel|bias)",
     lambda m, w: [(f"pts_bbox_head.transformer.{_TORCH_NAMES[m.group(1)]}."
                    f"{_WB[m.group(2)]}", _dense(m.group(2), w))]),
    (rf"{_T}/reference_points/(kernel|bias)",
     lambda m, w: [(f"pts_bbox_head.transformer.reference_points.{_WB[m.group(1)]}",
                 _dense(m.group(1), w))]),
    (rf"{_T}/(img|pts)_encoder/layer(\d+)/(.+)", _encoder),
    (r"pts_backbone/block(\d+)_(conv|bn)(\d+)/(kernel|\w+)", _second),
    (r"pts_neck/deblock(\d+)_(conv|bn)/(\w+)", _secondfpn),
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


def _basic_blocks(variables) -> Dict[int, int]:
    """Stage -> basic-block count of the SparseEncoder in ``variables``."""
    n: Dict[int, int] = {}
    for path, _ in _flatten(variables.get("params", {}).get(_ME, {})):
        if m := re.fullmatch(r"stage(\d+)_block(\d+)", path[0]):
            i, j = int(m.group(1)), int(m.group(2))
            n[i] = max(n.get(i, 0), j + 1)
    return n


def _bev_embedding(w, embed_dims):
    """The BEV query embedding under its reference names: one (HW, C) table,
    or with dual queries (a (HW, 2C) table) its camera and LiDAR halves."""
    if embed_dims is not None and w.shape[1] == 2 * embed_dims:
        return [("pts_bbox_head.bev_embedding_img.weight", w[:, :embed_dims]),
                ("pts_bbox_head.bev_embedding_pts.weight", w[:, embed_dims:])]
    return [("pts_bbox_head.bev_embedding.weight", w)]


def _embed_dims(variables):
    """The transformer's embed_dims, from its level embeddings (None when
    ``variables`` holds neither)."""
    t = variables.get("params", {}).get(_H, {}).get("transformer", {})
    for name in ("img_level_embeds", "pts_level_embeds"):
        if name in t:
            return np.shape(t[name])[-1]
    return None


def _fpn_levels(variables) -> int:
    """The FPN's level convs, after which its extra levels are numbered."""
    neck = variables.get("params", {}).get("img_neck", {})
    return sum(1 for k in neck if re.fullmatch(r"fpn\d+", k))


def jax_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """The port's state_dict from the JAX UniBEV's variables."""
    out: Dict[str, np.ndarray] = {}
    in_proj: Dict = {}
    unknown = []
    n_basic = _basic_blocks(variables)
    dims, levels = _embed_dims(variables), _fpn_levels(variables)
    rules = _RULES + [
        (_ME + r"/(.+)", lambda m, w: _middle(m, w, n_basic)),
        (rf"{_H}/bev_embedding", lambda m, w: _bev_embedding(w, dims)),
        (r"img_neck/extra(\d+)/(kernel|bias)",
         lambda m, w: [(f"img_neck.fpn_convs.{levels + int(m.group(1))}.conv."
                        f"{_WB[m.group(2)]}",
                        _conv(w) if m.group(2) == "kernel" else w)]),
    ]
    for col in ("params", "constants", "batch_stats"):
        for path, w in _flatten(variables.get(col, {})):
            joined = "/".join(path)
            items = None
            for pattern, handler in rules:
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
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
