"""Weights and boundaries of the port.

* ``jax_to_state_dict`` inverts ``convert_state_dict`` on the camera-only
  key set of the reference checkpoint (tools/ref_inventory.py): every key
  comes back, bit for bit.  On the LiDAR keys every key comes back too, bit
  for bit but for the SECONDFPN transposed conv, which comes back mirrored
  in both spatial axes: ``convert_state_dict`` does not flip it for flax's
  ``ConvTranspose``, ``jax_to_state_dict`` does.
* The port's C-only UniBEV carries exactly those keys: the reference
  state_dict and the converted one both load with ``strict=True``.  The LC
  flagship carries exactly the reference flagship's keys and shapes.
* Importing every module of the port (its config loader included) imports
  no JAX, flax or unibev_tpu.
* A kernel wrapper given CPU tensors takes the plain version and does not
  count a launch.
* The converter refuses a variable the slice has no key for.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from unibev_tpu.utils.convert_torch import convert_state_dict

from unibev_tpu_torch.flagship import build_model, flagship_model_cfg
from unibev_tpu_torch.models.detectors.unibev import UniBEV
from unibev_tpu_torch.ops import _build
from unibev_tpu_torch.ops.deform_conv import (deform_im2col,
                                              deform_im2col_reference)
from unibev_tpu_torch.ops.msda import ms_deform_attn, ms_deform_attn_reference
from unibev_tpu_torch.utils.convert_jax import jax_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from ref_inventory import (decoder_keys, encoder_keys,  # noqa: E402
                           flagship_state_dict, fpn_keys, head_keys,
                           resnet101_keys, second_keys, secondfpn_keys,
                           sparse_encoder_keys, transformer_top_keys)

C, HEADS = 32, 4


def _camera_state_dict():
    """The C-only reference keys: ResNet-101 with DCN at full width (the
    inventory has no smaller one), everything after it at C=32."""
    rng = np.random.RandomState(0)
    sd = {}
    resnet101_keys(sd, rng)
    fpn_keys(sd, rng, cout=C)
    transformer_top_keys(sd, rng, C=C, num_cams=2, use_pts=False)
    encoder_keys(sd, rng, "img", n_layers=1, C=C, heads=HEADS)
    decoder_keys(sd, rng, n_layers=2, C=C, heads=HEADS)
    head_keys(sd, rng, C=C, num_query=12, bev_hw=(8, 8), num_pred=2)
    return sd


def _camera_cfg():
    pc = (-9.6, -9.6, -2.0, 9.6, 9.6, 2.0)
    return dict(
        use_lidar=False, img_shape=(64, 96),
        img_backbone=dict(depth=101, stage_with_dcn=(False, False, True, True),
                          dcn=dict(type="DCNv2")),
        img_neck=dict(in_channels=(2048,), out_channels=C),
        pts_bbox_head=dict(
            in_channels=C, num_query=12, bev_h=8, bev_w=8,
            positional_encoding=dict(num_feats=C // 2, row_num_embed=8,
                                     col_num_embed=8),
            transformer=dict(
                embed_dims=C, num_cams=2, feature_norm="ChannelNormWeights",
                img_encoder=dict(num_layers=1, pc_range=pc, transformerlayers=dict(
                    attn_cfgs=[dict(embed_dims=C, num_heads=HEADS),
                               dict(deformable_attention=dict(
                                   embed_dims=C, num_heads=HEADS))])),
                decoder=dict(num_layers=2, transformerlayers=dict(
                    attn_cfgs=[dict(embed_dims=C, num_heads=HEADS),
                               dict(embed_dims=C, num_heads=HEADS)])))))


def test_roundtrip_and_strict_load():
    sd = _camera_state_dict()
    conv = convert_state_dict(sd, num_heads=HEADS)
    assert conv["unmapped"] == []
    back = jax_to_state_dict({"params": conv["params"],
                              "constants": conv["constants"]})
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)

    model = build_model(_camera_cfg(), "cpu")
    assert sorted(model.state_dict()) == sorted(sd)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                          strict=True)
    model.load_state_dict(back, strict=True)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import unibev_tpu_torch\n"
        "for m in pkgutil.walk_packages(unibev_tpu_torch.__path__, 'unibev_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'unibev_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('unibev_tpu_torch')]))\n"
        "assert not bad, bad\n"
        "assert 'unibev_tpu_torch.config.config' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20          # every module was imported


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.RandomState(0)
    value = torch.from_numpy(rng.randn(1, 20, 2, 4).astype(np.float32))
    loc = torch.from_numpy(rng.rand(1, 5, 2, 1, 3, 2).astype(np.float32))
    attn = torch.from_numpy(rng.rand(1, 5, 2, 1, 3).astype(np.float32))
    x = torch.from_numpy(rng.randn(1, 6, 7, 3).astype(np.float32))
    off = torch.from_numpy(rng.randn(1, 6, 7, 18).astype(np.float32))
    mask = torch.from_numpy(rng.rand(1, 6, 7, 9).astype(np.float32))
    before = dict(_build.launches)
    torch.testing.assert_close(ms_deform_attn(value, ((4, 5),), loc, attn),
                               ms_deform_attn_reference(value, ((4, 5),), loc, attn),
                               rtol=0, atol=0)
    torch.testing.assert_close(deform_im2col(x, off, mask),
                               deform_im2col_reference(x, off, mask),
                               rtol=0, atol=0)
    assert dict(_build.launches) == before
    assert _build._lib is None            # nothing was built or loaded


def test_converter_refuses_variables_outside_the_slice():
    """A variable the port has no key for raises (the JAX PillarFeatureNet
    has no BatchNorm); the radar branch's own variables map."""
    bad = {"params": {"radar_voxel_encoder": {"bn0": {
        "scale": np.zeros((64,))}}}}
    with pytest.raises(KeyError, match="radar_voxel_encoder/bn0/scale"):
        jax_to_state_dict(bad)
    kernel = np.arange(9 * 64, dtype=np.float32).reshape(9, 64)
    sd = jax_to_state_dict({"params": {"radar_voxel_encoder": {
        "fc0": {"kernel": kernel}, "ln0": {"scale": np.ones(64),
                                           "bias": np.zeros(64)}}}})
    assert sorted(sd) == ["radar_voxel_encoder.fc0.weight",
                          "radar_voxel_encoder.ln0.bias",
                          "radar_voxel_encoder.ln0.weight"]
    np.testing.assert_array_equal(sd["radar_voxel_encoder.fc0.weight"].numpy(),
                                  kernel.T)


def test_lidar_roundtrip_flips_only_the_deconv():
    """The LiDAR keys at the flagship's widths (pts encoder at C=32)."""
    rng = np.random.RandomState(0)
    sd = {}
    sparse_encoder_keys(sd, rng)
    second_keys(sd, rng)
    secondfpn_keys(sd, rng)
    encoder_keys(sd, rng, "pts", n_layers=1, C=C, heads=HEADS)
    sd["pts_bbox_head.transformer.pts_level_embeds"] = rng.randn(1, C)
    conv = convert_state_dict(sd, num_heads=HEADS)
    assert conv["unmapped"] == []
    back = jax_to_state_dict({"params": conv["params"],
                              "batch_stats": conv["batch_stats"]})
    assert sorted(back) == sorted(sd)
    deconv = "pts_neck.deblocks.1.0.weight"
    for k, v in sd.items():
        want = v[:, :, ::-1, ::-1] if k == deconv else v
        np.testing.assert_array_equal(back[k].numpy(), want, err_msg=k)
    assert back["pts_middle_encoder.conv_out.0.weight"].shape == (3, 1, 1, 128, 128)


def test_lc_flagship_has_the_reference_keys_and_shapes():
    with torch.device("meta"):
        model = UniBEV(**flagship_model_cfg())
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {k: tuple(np.shape(v)) for k, v in flagship_state_dict().items()}
    assert got == want
