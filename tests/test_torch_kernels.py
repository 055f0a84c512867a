"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips on a CPU-only
machine; the file imports no JAX, so it runs where only PyTorch is
installed::

    python -m pytest tests/test_torch_kernels.py -m cuda -q

Tolerances are relative to max |plain| (at least 1): f32 1e-4 for the
DCN columns and product, 1e-5 for MSDA (the same terms summed in another
order, TF32 off); bf16 2^-6 (outputs rounded to bf16, relative 2^-8, with
margin).
"""

import numpy as np
import pytest
import torch

from torch_port_utils import cuda_device  # noqa: F401
from unibev_tpu_torch.ops import _build
from unibev_tpu_torch.ops.deform_conv import (
    deform_im2col, deform_im2col_reference, modulated_deform_conv2d,
    modulated_deform_conv2d_reference)
from unibev_tpu_torch.ops.msda import ms_deform_attn, ms_deform_attn_reference

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _close(got, want, rel):
    tol = rel * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


def _msda_inputs(device, dtype, levels, P, B=2, Q=300, heads=8, D=32, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    V = sum(h * w for h, w in levels)
    L = len(levels)
    value = torch.randn(B, V, heads, D, device=device, generator=g).to(dtype)
    loc = torch.rand(B, Q, heads, L, P, 2, device=device, generator=g) * 1.2 - 0.1
    attn = torch.softmax(torch.randn(B, Q, heads, L * P, device=device,
                                     generator=g), -1)
    return value, loc, attn.view(B, Q, heads, L, P).to(dtype)


def _dcn_inputs(device, dtype, B=2, H=11, W=13, Cin=40, Cout=24, stride=2,
                seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = torch.randn(B, H, W, Cin, device=device, generator=g).to(dtype)
    off = (torch.randn(B, Ho, Wo, 18, device=device, generator=g) * 2.5).to(dtype)
    mask = torch.rand(B, Ho, Wo, 9, device=device, generator=g).to(dtype)
    w = (torch.randn(9 * Cin, Cout, device=device, generator=g) * 0.05).to(dtype)
    return x, off, mask, w


@pytest.mark.parametrize("levels,P", [(((29, 50),), 8), (((29, 50), (7, 9)), 4),
                                      (((200, 200),), 4)], ids=["sca", "L2", "bev"])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_msda_kernel_matches_plain(cuda_device, levels, P, dtype, rel):
    value, loc, attn = _msda_inputs(cuda_device, dtype, levels, P)
    before = _build.launches["msda_fwd"]
    got = ms_deform_attn(value, levels, loc, attn)
    torch.cuda.synchronize()
    assert _build.launches["msda_fwd"] == before + 1
    assert got.dtype == dtype and got.shape == (2, 300, 8 * 32)
    _close(got, ms_deform_attn_reference(value, levels, loc, attn), rel)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -6)],
                         ids=["f32", "bf16"])
def test_dcn_kernel_matches_plain(cuda_device, stride, dtype, rel):
    x, off, mask, w = _dcn_inputs(cuda_device, dtype, stride=stride)
    before = _build.launches["dcn_im2col"]
    cols = deform_im2col(x, off, mask, stride=stride)
    out = modulated_deform_conv2d(x, off, mask, w, stride=stride)
    torch.cuda.synchronize()
    assert _build.launches["dcn_im2col"] == before + 2
    _close(cols, deform_im2col_reference(x, off, mask, stride=stride), rel)
    _close(out, modulated_deform_conv2d_reference(x, off, mask, w, stride=stride),
           rel)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    value, loc, attn = _msda_inputs(cuda_device, torch.float32, ((29, 50),), 8)
    with pytest.raises(NotImplementedError):
        ms_deform_attn(value.requires_grad_(), ((29, 50),), loc, attn)
    value = value.detach()
    with pytest.raises(TypeError):
        ms_deform_attn(value.half(), ((29, 50),), loc, attn.half())
    with pytest.raises(ValueError):
        ms_deform_attn(value, ((29, 49),), loc, attn)
    with pytest.raises(ValueError):
        ms_deform_attn(value, ((29, 50),), loc.cpu(), attn)
    x, off, mask, _ = _dcn_inputs(cuda_device, torch.float32)
    with pytest.raises(NotImplementedError):
        deform_im2col(x.requires_grad_(), off, mask, stride=2)
    with pytest.raises(ValueError):
        deform_im2col(x.detach(), off, mask, stride=1)
    with pytest.raises(ValueError):
        deform_im2col(x.detach().transpose(1, 2), off, mask, stride=2)


def test_plain_versions_agree_with_themselves_on_cpu_and_card(cuda_device):
    """The plain versions are the card-side reference: they must give the
    CPU's answer on the card (TF32 off)."""
    value, loc, attn = _msda_inputs("cpu", torch.float32, ((29, 50),), 8)
    want = ms_deform_attn_reference(value, ((29, 50),), loc, attn)
    got = ms_deform_attn_reference(value.to(cuda_device), ((29, 50),),
                                   loc.to(cuda_device), attn.to(cuda_device))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5)
