"""The UniBEV detector (``model.type = 'UniBEV'``): what the harness knows of
it, found by the type its configuration files name.

A detector file gives the harness, for one detector type:

* ``REFERENCE``: the plain reference's class (``benchmark/reference/``);
* ``build_port(config_file, device, train)`` and ``served_dtype(config_file)``:
  the port's model of a config file, and the type its weights are served in;
* ``of_model(model)``: the shape-defining values a configuration file's
  ``expect`` states;
* ``CAPTURES`` and ``FORCED``: the layer outputs the check compares end to
  end, and those its step-by-step check reads of the port alone, with
  ``EXACT`` (numbers compared exactly) and ``PER_FORWARD`` (one count a
  forward, not a sample); ``forced(ref, got, device)``: the step-by-step
  numbers; ``describe(got)``: a line for standard error about one sampled
  call, or None;
* ``LAYERS`` and ``OPS``: the layer ranges and the op sites of the port's
  modules that the traced part wraps (``spans.install``); ``REF_OPS``: the
  sites of the reference at which ``run.count_flops`` counts an op's work
  (``work/<op>.py``) beside what aten counts;
* ``init_rules(model)``: initialization rules of the reference's state dict
  that this detector adds to (or puts in place of) ``weights._rules``';
* ``FAULTS``: faults that know the detector's modules, beside those of
  ``faults.py``.

UniBEV is stateless: each ``predict`` call depends on its batch alone.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from benchmark.check import decode_gap, rel_l2
from benchmark.reference.models.detectors.unibev import UniBEV as REFERENCE

# name: (module path, how to read it from the module's output and inputs)
CAPTURES = {
    "img_feat": ("img_neck", lambda out, args: out[0]),
    "pts_feat": ("pts_neck", lambda out, args: out),
    "img_bev": ("pts_bbox_head.transformer.img_bev_encoder",
                lambda out, args: out[0]),
    "pts_bev": ("pts_bbox_head.transformer.pts_bev_encoder",
                lambda out, args: out),
    "fused": ("pts_bbox_head.transformer.decoder", lambda out, args: args[1]),
    "voxels": ("", lambda out, args: out.get("num_distinct_voxels")),
    "overflow": ("", lambda out, args: out.get("sparse_overflow")),
}
# what the step-by-step check reads of the port alone
FORCED = {
    "dec_query": ("pts_bbox_head.transformer.decoder", lambda out, args: args[0]),
    "dec_pos": ("pts_bbox_head.transformer.decoder", lambda out, args: args[2]),
    "states": ("pts_bbox_head.transformer.decoder", lambda out, args: out[0]),
    "refs": ("pts_bbox_head.transformer.decoder", lambda out, args: out[1]),
    "cls_out": ("pts_bbox_head", lambda out, args: out["all_cls_scores"]),
    "box_out": ("pts_bbox_head", lambda out, args: out["all_bbox_preds"]),
}
# numbers compared exactly (counts); the others by relative L2 error
EXACT = ("voxels", "overflow", "decode")
# counts of a whole forward, not of a sample
PER_FORWARD = ("overflow",)

# layer: (attribute paths from the detector; a path names a submodule, whose
# forward is wrapped, or a bound method of one)
LAYERS = {
    "camera_backbone": ("extract_img_feat",),
    "lidar_branch": ("extract_pts_feat",),
    "bev_encoders": ("pts_bbox_head.transformer.img_bev_encoder",
                     "pts_bbox_head.transformer.pts_bev_encoder"),
    "head": ("pts_bbox_head", "pts_bbox_head.get_bboxes"),
}

# op: (module of the port, the name a layer calls the op by)
OPS = {
    "dcn_fwd": (("unibev_tpu_torch.models.backbones.resnet",
                 "modulated_deform_conv2d"),),
    "msda_fwd": (("unibev_tpu_torch.models.attention.deformable",
                  "ms_deform_attn"),),
    "sparse_conv": (("unibev_tpu_torch.models.middle_encoder", "sparse_conv"),
                    ("unibev_tpu_torch.models.middle_encoder",
                     "subm_neighbor_idx"),
                    ("unibev_tpu_torch.models.middle_encoder",
                     "strided_neighbor_idx")),
}

# op: (module of the reference, the name it calls the op by): the deformable
# attention's sampling, which aten sees as grid_sample
REF_OPS = {
    "msda_fwd": (("benchmark.reference.models.attention.deformable",
                  "ms_deform_attn"),),
}

FREE_STD = {"modal_embbeding_C": 0.02, "modal_embbeding_L": 0.02}


def build_port(config_file: str, device, train: bool) -> nn.Module:
    """The port's model of ``config_file`` (``flagship.build_model_from_config``)."""
    from unibev_tpu_torch import flagship
    return flagship.build_model_from_config(config_file, device=device,
                                            train=train)


def served_dtype(config_file: str) -> torch.dtype:
    """The type the config file's weights are served in."""
    from unibev_tpu_torch import flagship
    return flagship.model_cfg_from_config(config_file)["dtype"]


def init_rules(model: nn.Module) -> Dict:
    """The fixed modality embeddings' small normal draws."""
    rules = {}
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        for k, _ in m.named_parameters(recurse=False):
            if k in FREE_STD:
                rules[prefix + k] = ("normal", FREE_STD[k])
    return rules


def of_model(model: nn.Module) -> Dict:
    """The shape-defining values of a built UniBEV model, which each
    configuration file (``configs/<name>.json``, ``expect``) states and the
    run checks before it measures: a later edit of the repository's config
    file cannot change the yardstick unseen."""
    out: Dict = {
        "dtype": str(model.compute_dtype).replace("torch.", ""),
        "parameters": sum(p.numel() for p in model.parameters()),
        "use_camera": bool(model.use_camera),
        "use_lidar": bool(model.use_lidar),
    }
    head = model.pts_bbox_head
    tr = head.transformer
    out.update(bev=[head.bev_h, head.bev_w], embed_dims=tr.embed_dims,
               num_query=head.num_query if hasattr(head, "num_query")
               else None,
               fusion=tr.fusion_method, feature_norm=tr.feature_norm,
               decoder_layers=len(tr.decoder.layers))
    if out["num_query"] is None:
        out.pop("num_query")
    if model.use_camera:
        bb = model.img_backbone
        out.update(
            resnet_blocks=[len(getattr(bb, f"layer{i}")) for i in range(1, 5)],
            dcn_stages=[any(type(m).__name__ == "DeformConv2d"
                            for m in getattr(bb, f"layer{i}").modules())
                        for i in range(1, 5)],
            camera_encoder_layers=len(tr.img_bev_encoder.layers))
    if model.use_lidar:
        me = model.pts_middle_encoder
        out.update(voxel_size=list(model.voxel_size),
                   max_voxels=model.max_voxels,
                   max_points_per_voxel=model.max_points_per_voxel,
                   sparse_shape=list(me.sparse_shape),
                   sparse_capacities=list(me.capacities),
                   lidar_encoder_layers=len(tr.pts_bev_encoder.layers))
    return out


def describe(got: Dict[str, torch.Tensor]):
    """The LiDAR branch's counts of one sampled call, where it ran."""
    if "voxels" not in got:
        return None
    return (f"distinct voxels {got['voxels'].tolist()}, "
            f"sparse overflow {got['overflow'].tolist()}")


def answer_altered(call, model):
    """One sample's boxes altered where the head produces them."""
    def hook(module, args, out):
        out["all_bbox_preds"][:, 0, :, 0] += 0.5
        return out
    model.pts_bbox_head.register_forward_hook(hook)
    return call


FAULTS = {"answer_altered": answer_altered}


@torch.no_grad()
def forced(ref: nn.Module, got: Dict[str, torch.Tensor],
           device) -> Dict[str, float]:
    """The decoder layers and the head's branches of the reference ``ref``
    run step by step on the port's own state ``got`` (:data:`FORCED`):
    ``decoder`` (each layer's output), ``refs`` (each layer's reference
    points), ``cls`` and ``box`` (each layer's class scores and boxes),
    each the largest over layers and samples; and ``decode``, the rows of
    ``predict``'s output that differ from the reference's decoding of the
    port's last layer.

    Each of the six decoder layers is run by the reference on the port's
    input to that layer (its query, the fused BEV map, the positions and
    the reference points the port refined), against the port's output of
    that layer; the reference points, the first layer's against the
    reference's from the port's query positions and each later layer's
    against the reference's refinement of the layer before (its state and
    points); the class and box branches of every layer on the port's
    decoder states.  Run end to end, the six layers' box refinement moves
    each layer's sampling points by what the layers before it rounded, and
    the last layers' outputs then differ by 10-25% in bf16 and in fp8
    alike, which no limit separates; the decoder's input, the fused map, is
    compared end to end (``fused``)."""
    from benchmark.reference.models.layers import inverse_sigmoid
    if "states" not in got:
        return {}
    head = ref.pts_bbox_head
    tr = head.transformer
    on = {k: got[k].to(device).float() for k in FORCED if k in got}
    value, pos = got["fused"].to(device).float(), on["dec_pos"]
    states, refs = on["states"], on["refs"]
    query = on["dec_query"]
    pr = head.pc_range
    dec = cls = box = 0.0
    points = rel_l2(refs[0], torch.sigmoid(tr.reference_points(pos)))
    last = len(tr.decoder.layers) - 1
    for lvl, layer in enumerate(tr.decoder.layers):
        out = layer(query, value, pos, refs[lvl][..., None, :2],
                    ((tr.bev_h, tr.bev_w),))
        dec = max(dec, rel_l2(states[lvl], out))
        query = states[lvl]
        cls = max(cls, rel_l2(on["cls_out"][lvl],
                              head.cls_branches[lvl](states[lvl])))
        reference = inverse_sigmoid(refs[lvl])
        tmp = head.reg_branches[lvl](states[lvl])
        xy = torch.sigmoid(tmp[..., 0:2] + reference[..., 0:2])
        z = torch.sigmoid(tmp[..., 4:5] + reference[..., 2:3])
        if lvl < last:
            points = max(points, rel_l2(refs[lvl + 1],
                                        torch.cat([xy, z], dim=-1)))
        want = torch.cat([xy[..., 0:1] * (pr[3] - pr[0]) + pr[0],
                          xy[..., 1:2] * (pr[4] - pr[1]) + pr[1], tmp[..., 2:4],
                          z * (pr[5] - pr[2]) + pr[2], tmp[..., 5:]], dim=-1)
        box = max(box, rel_l2(on["box_out"][lvl], want))
    numbers = {"decoder": dec, "refs": points, "cls": cls, "box": box}
    if "decoded" in got:
        decoded = head.get_bboxes({"all_cls_scores": on["cls_out"],
                                   "all_bbox_preds": on["box_out"]})
        numbers["decode"] = decode_gap(got["decoded"], decoded)
    return numbers
