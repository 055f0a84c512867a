"""The shape-defining values of a built UniBEV model, which each
configuration file (``configs/<name>.json``, ``expect``) states and the run
checks before it measures: a later edit of the repository's config file
cannot change the yardstick unseen."""

from __future__ import annotations

from typing import Dict

from torch import nn


def of_model(model: nn.Module) -> Dict:
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
