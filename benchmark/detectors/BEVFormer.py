"""The BEVFormer detector (``model.type = 'BEVFormer'``): what the harness
knows of it, found by the type its configuration file names (the items
are those ``detectors/UniBEV.py`` describes).

BEVFormer is stateful: each slot of the batch keeps the previous frame's
BEV map, pose and yaw (the port's ``history`` module; the reference's
``prev_frame_info``), so the check replays the scene (scene traffic,
``traffic.replay``).  Both models hand the stored map and the frame's CAN
bus deltas to ``pts_bbox_head.transformer.align``, whose inputs and
outputs the check reads.  Beside UniBEV's numbers it compares
``prev_bev``, the aligned previous map the temporal self-attention reads,
``history``, ``scene_frame`` and ``sca_overflow`` (exact; a wrong history
at a scene's first frame fades from the maps within a few frames, and
``scene_frame``, the frame's index in its scene as the state counts it,
shows it at every frame after), and it runs two steps from the
port's own state: ``tsa``, the reference's first temporal self-attention on
the port's query, aligned previous map and shifted reference points, and
``align``, the reference's rotation and shift on the port's stored
previous map and CAN bus deltas.  Rounding carried through the recurrence
grows with the frame's index in the scene; those two tell it apart from a
wrong op.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from benchmark.check import rel_l2
from benchmark.reference.models.attention.deformable import grid_offset_bias
from benchmark.reference.models.attention.temporal import \
    TemporalSelfAttention
from benchmark.reference.models.detectors.bevformer import \
    BEVFormer as REFERENCE  # noqa: F401
from benchmark.spec import load_file

_unibev = load_file("detectors", "UniBEV")

TRANSFORMER = "pts_bbox_head.transformer"
ENCODER = f"{TRANSFORMER}.encoder"
ALIGN = f"{TRANSFORMER}.align"
TSA0 = f"{ENCODER}.layers.0.attentions.0"
ENCODER_LAYERS = 6


def _levels(out, args) -> torch.Tensor:
    """Every FPN level of each image, flattened and concatenated."""
    return torch.cat([f.flatten(1) for f in out], 1)


CAPTURES = {
    "img_feat": ("img_neck", _levels),
    "prev_bev": (ALIGN, lambda out, args: out[0]),
    "img_bev": (ENCODER, lambda out, args: out[0]),
    "fused": (f"{TRANSFORMER}.decoder", lambda out, args: args[1]),
    "history": ("", lambda out, args: out.get("history")),
    "scene_frame": ("", lambda out, args: out.get("scene_frame")),
    "sca_overflow": ("", lambda out, args: out.get("sca_overflow")),
}


def _tsa_inputs(args):
    """(query, query_pos, previous map, current map, history, reference
    points) of a temporal self-attention call: the port's arguments
    (query, query_pos, prev_bev, cur_bev, history, reference_points,
    shapes) or the reference's (query, value, query_pos, reference_points,
    shapes), whose value is each sample's queue [prev, cur], or None where
    the frame has no history."""
    if len(args) == 7:
        return args[:6]
    query, value, pos, ref, _ = args
    B = query.shape[0]
    history = torch.full((B,), value is not None, dtype=torch.bool,
                         device=query.device)
    if value is None:
        return query, pos, query, query, history, ref
    queue = value.view(B, 2, *value.shape[1:])
    return query, pos, queue[:, 0], queue[:, 1], history, ref


_TSA_NAMES = ("query", "pos", "prev", "cur", "history", "ref")

# what the step-by-step checks read (of the port, and of the control in its
# place): UniBEV's decoder and head; the alignment's inputs (the stored
# previous map, the CAN bus rows with their deltas) and its shift; the
# first temporal self-attention's inputs and output
FORCED = dict(
    _unibev.FORCED,
    prev_raw=(ALIGN, lambda out, args: args[0]),
    can_bus=(ALIGN, lambda out, args: torch.as_tensor(args[1])),
    shift=(ALIGN, lambda out, args: out[1]),
    tsa_out=(TSA0, lambda out, args: out),
    **{f"tsa_{name}": (TSA0, lambda out, args, k=k: _tsa_inputs(args)[k])
       for k, name in enumerate(_TSA_NAMES)})
EXACT = ("decode", "history", "scene_frame", "sca_overflow")
PER_FORWARD = ("sca_overflow",)

LAYERS = {
    "camera_backbone": ("extract_img_feat",),
    "bev_align": (ALIGN,),
    "temporal_attention": tuple(f"{ENCODER}.layers.{i}.attentions.0"
                                for i in range(ENCODER_LAYERS)),
    "bev_encoders": (ENCODER,),
    "head": ("pts_bbox_head", "pts_bbox_head.get_bboxes"),
}

OPS = {
    "dcn_fwd": _unibev.OPS["dcn_fwd"],
    "msda_fwd": _unibev.OPS["msda_fwd"],
    "msda_tsa": (("unibev_tpu_torch.models.attention.temporal",
                  "ms_deform_attn"),),
}
REF_OPS = {
    "msda_fwd": _unibev.REF_OPS["msda_fwd"],
    "msda_tsa": (("benchmark.reference.models.attention.temporal",
                  "ms_deform_attn"),),
}

build_port = _unibev.build_port
served_dtype = _unibev.served_dtype


def init_rules(model: nn.Module) -> Dict:
    """The temporal self-attention's grid bias of its sampling offsets, over
    heads x (levels x queue) x points x 2, as the published
    ``TemporalSelfAttention.init_weights`` lays it out."""
    rules = {}
    for name, m in model.named_modules():
        if isinstance(m, TemporalSelfAttention):
            bias = grid_offset_bias(m.num_heads, m.num_levels * m.num_bev_queue,
                                    m.num_points)
            rules[f"{name}.sampling_offsets.bias"] = ("tensor", bias)
    return rules


def of_model(model: nn.Module) -> Dict:
    """The shape-defining values of a built BEVFormer model (see
    ``detectors/UniBEV.py``)."""
    head = model.pts_bbox_head
    tr = head.transformer
    enc = tr.encoder
    tsa = enc.layers[0].attentions[0]
    sca = enc.layers[0].attentions[1].deformable_attention
    bb = model.img_backbone
    return {
        "dtype": str(model.compute_dtype).replace("torch.", ""),
        "parameters": sum(p.numel() for p in model.parameters()),
        "bev": [head.bev_h, head.bev_w], "embed_dims": tr.embed_dims,
        "num_query": head.query_embedding.num_embeddings,
        "pc_range": list(head.pc_range),
        "img_shape": list(model.img_shape),
        "resnet_blocks": [len(getattr(bb, f"layer{i}")) for i in range(1, 5)],
        "dcn_stages": [any(type(m).__name__ == "DeformConv2d"
                           for m in getattr(bb, f"layer{i}").modules())
                       for i in range(1, 5)],
        "out_indices": list(bb.out_indices),
        "fpn_levels": model.img_neck.num_outs,
        "encoder_layers": len(enc.layers),
        "decoder_layers": len(tr.decoder.layers),
        "tsa": [tsa.num_bev_queue, tsa.num_heads, tsa.num_levels,
                tsa.num_points],
        "sca": [sca.num_heads, sca.num_levels, sca.num_points],
        "rebatch_k": enc.rebatch_k,
        "rotate_center": list(tr.align.rotate_center),
        "video_test_mode": bool(model.video_test_mode),
    }


def describe(got: Dict[str, torch.Tensor]):
    """The frame's history flags, yaw change and shift."""
    if "can_bus" not in got or "shift" not in got:
        return None
    return (f"history {got['history'].tolist()}, yaw change "
            f"{got['can_bus'][:, -1].tolist()} deg, shift (x, y) "
            f"{got['shift'].tolist()}")


def rotation_reversed(call, model):
    """The previous map rotated by the negated yaw change."""
    align = model.pts_bbox_head.transformer.align
    rotate = align.rotate
    align.rotate = lambda prev, angle, keep: rotate(prev, -angle, keep)
    return call


FAULTS = {"rotation_reversed": rotation_reversed}


def _tsa(ref: nn.Module, got: Dict[str, torch.Tensor], device) -> float:
    """The reference's first temporal self-attention on the port's inputs
    to it, sample by sample, against the port's output."""
    head = ref.pts_bbox_head
    layer = head.transformer.encoder.layers[0].attentions[0]
    t = {k: got[k].to(device) for k in ("tsa_query", "tsa_pos", "tsa_prev",
                                         "tsa_cur", "tsa_ref", "tsa_out")}
    t = {k: v.float() for k, v in t.items()}
    worst = 0.0
    for b, hist in enumerate(got["tsa_history"].tolist()):
        value = (torch.stack([t["tsa_prev"][b], t["tsa_cur"][b]])
                 if hist else None)
        out = layer(t["tsa_query"][b:b + 1], value, t["tsa_pos"][b:b + 1],
                    t["tsa_ref"][2 * b:2 * b + 2], [(head.bev_h, head.bev_w)])
        worst = max(worst, rel_l2(t["tsa_out"][b:b + 1], out))
    return worst


def _align(ref: nn.Module, got: Dict[str, torch.Tensor], device) -> float:
    """The reference's rotation and shift on the port's stored previous map
    and CAN bus rows, against the port's aligned map and shift, for each
    sample with history (0 where none has: the port's map is then zero and
    unused)."""
    head = ref.pts_bbox_head
    grid = (head.real_h / head.bev_h, head.real_w / head.bev_w)
    worst = 0.0
    for b, hist in enumerate(got["history"].tolist()):
        if not hist:
            continue
        prev, shift = head.transformer.align(
            got["prev_raw"][b:b + 1].to(device).float(),
            got["can_bus"][b:b + 1].double().numpy(), grid, device)
        worst = max(worst, rel_l2(got["prev_bev"][b:b + 1].to(device), prev),
                    rel_l2(got["shift"][b:b + 1].to(device), shift))
    return worst


@torch.no_grad()
def forced(ref: nn.Module, got: Dict[str, torch.Tensor],
           device) -> Dict[str, float]:
    """UniBEV's step-by-step numbers (``decoder``, ``refs``, ``cls``,
    ``box``, ``decode``), ``tsa`` and ``align``."""
    numbers = _unibev.forced(ref, got, device)
    if "tsa_out" in got:
        numbers["tsa"] = _tsa(ref, got, device)
    if "prev_raw" in got:
        numbers["align"] = _align(ref, got, device)
    elif "history" in got:
        # no state was held at all: nothing was aligned
        numbers["align"] = 0.0 if not bool(got["history"].any()) \
            else float("inf")
    return numbers
