"""K13's plain version and its autograd against the frozen-BN sequence it
replaces, on the CPU (no JAX).

``frozen_bn_act`` fuses a frozen BN with its ReLU and the bottleneck's
residual add: (a) ``relu(bn(x))``, (b) ``relu(bn3(x) + r)``, (c)
``relu(bn3(x) + bn_ds(d))``.  The sequence it replaces is the module's own
``FrozenBatchNorm.forward`` (the affine applied in x's dtype) followed by
``F.relu`` and the add.  float32: the same operations in the same order, so
equal to 1e-6 relative (they are equal).  bfloat16: the plain version rounds
once, so it equals the float32 sequence on the same bf16 values rounded to
bf16.  The buffers are drawn away from the identity (weight, bias and mean
normal, var in [0.5, 2]) so that every term counts.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unibev_tpu_torch.models.backbones.resnet import (Bottleneck,
                                                      FrozenBatchNorm, ResNet)
from unibev_tpu_torch.ops.frozen_bn import (frozen_bn_act,
                                            frozen_bn_act_reference)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from ref_inventory import resnet101_keys  # noqa: E402

FORMS = ("a", "b", "c")
DTYPES = (torch.float32, torch.bfloat16)
CHANNELS = (64, 256, 2048)


def _bn(C, gen, dtype=torch.float32):
    bn = FrozenBatchNorm(C)
    bn.weight.copy_(torch.randn(C, generator=gen))
    bn.bias.copy_(torch.randn(C, generator=gen))
    bn.running_mean.copy_(torch.randn(C, generator=gen))
    bn.running_var.copy_(0.5 + 1.5 * torch.rand(C, generator=gen))
    return bn.to(dtype)


def _act(shape, gen, dtype):
    x = torch.randn(shape, generator=gen).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


def _case(form, C, dtype, seed=0):
    """x, the BN, and the form's residual or (down, down_bn)."""
    gen = torch.Generator().manual_seed(seed + C)
    shape = (2, C, 3, 5)
    x, bn = _act(shape, gen, dtype), _bn(C, gen, dtype)
    extra = {}
    if form == "b":
        extra = dict(residual=_act(shape, gen, dtype))
    if form == "c":
        extra = dict(down=_act(shape, gen, dtype), down_bn=_bn(C, gen, dtype))
    return x, bn, extra


def _sequence(x, bn, residual=None, down=None, down_bn=None):
    """The modules' sequence K13 replaces."""
    out = bn(x)
    if residual is not None:
        out = out + residual
    if down is not None:
        out = out + down_bn(down)
    return F.relu(out)


@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("form", FORMS)
def test_plain_matches_the_sequence(form, dtype, C):
    x, bn, extra = _case(form, C, dtype)
    got = frozen_bn_act_reference(x, bn, **extra)
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    if dtype == torch.float32:
        want = _sequence(x, bn, **extra)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        return
    # float32 arithmetic on the same bf16 values, rounded once
    up = {k: v.float() if k != "down_bn" else copy.deepcopy(v).float()
          for k, v in extra.items()}
    want = _sequence(x.float(), copy.deepcopy(bn).float(), **up)
    assert torch.equal(got, want.to(torch.bfloat16))
    assert ((got.float() - want).abs() <= 2 ** -8 * want.abs()).all()


@pytest.mark.parametrize("form", FORMS)
def test_gradients_match_the_sequence(form):
    x, bn, extra = _case(form, 64, torch.float32, seed=1)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(9))
    names = ["x"] + [k for k in ("residual", "down") if k in extra]
    grads = []
    for fn in (frozen_bn_act, _sequence):
        leaves = {"x": x.detach().clone().requires_grad_()}
        leaves.update({k: extra[k].detach().clone().requires_grad_()
                       for k in names[1:]})
        kwargs = {k: v for k, v in leaves.items() if k != "x"}
        if "down_bn" in extra:
            kwargs["down_bn"] = extra["down_bn"]
        out = fn(leaves["x"], bn, **kwargs)
        grads.append(torch.autograd.grad(out, [leaves[k] for k in names], g))
    for name, got, want in zip(names, *grads):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0, msg=name)
    assert not any(b.requires_grad for b in bn.buffers())


def _old_bottleneck(block, x):
    """Bottleneck.forward as it was, module by module."""
    out = F.relu(block.bn1(block.conv1(x)))
    out = F.relu(block.bn2(block.conv2(out)))
    out = block.bn3(block.conv3(out))
    identity = x if block.downsample is None else block.downsample(x)
    return F.relu(out + identity)


@pytest.mark.parametrize("downsample", [False, True], ids=["identity", "down"])
def test_bottleneck_matches_the_old_sequence(downsample):
    gen = torch.Generator().manual_seed(3)
    inplanes = 32 if downsample else 64
    block = Bottleneck(inplanes, 16, stride=2 if downsample else 1,
                       downsample=downsample)
    for p in block.parameters():
        p.data.copy_(0.1 * torch.randn(p.shape, generator=gen))
    for m in block.modules():
        if isinstance(m, FrozenBatchNorm):
            m.load_state_dict(_bn(m.weight.shape[0], gen).state_dict())
    block.to(memory_format=torch.channels_last)
    x = _act((2, inplanes, 8, 8), gen, torch.float32)
    outs, grads = [], []
    for fn in (block, lambda t: _old_bottleneck(block, t)):
        block.zero_grad()
        xi = x.clone().requires_grad_()
        out = fn(xi)
        out.backward(torch.ones_like(out))
        outs.append(out.detach())
        grads.append([xi.grad] + [p.grad.clone() for p in block.parameters()])
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-7)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dcn", [False, True], ids=["plain", "dcn34"])
def test_resnet101_state_dict_keys(dcn):
    """The reference checkpoint's names and shapes, as
    ``tools/ref_inventory.py`` lists them, with the downsample BN at
    ``downsample.1``."""
    stages = (False, False, dcn, dcn)
    with torch.device("meta"):
        model = ResNet(depth=101, stage_with_dcn=stages,
                       dcn=dict(type="DCNv2", deform_groups=1) if dcn else None)
    want = {}
    resnet101_keys(want, np.random.RandomState(0), stages)
    got = {f"img_backbone.{k}": tuple(v.shape)
           for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in want.items()}
