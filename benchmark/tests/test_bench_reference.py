"""The frozen reference against the port's CPU path at tiny shapes: LC, L
and C predict, and the LC model's losses and every gradient."""

from __future__ import annotations

import pytest
import torch

from benchmark import check, traffic, weights
from benchmark.reference import build as ref_build
from benchmark.tests.tiny import TRAFFIC, write_config

SEED = 99


def _models(tmp_path, lidar=True):
    from unibev_tpu_torch.flagship import build_model_from_config
    path = write_config(tmp_path, lidar)
    state = weights.make_state(ref_build.build_meta(path), SEED, "cpu",
                               torch.float32)
    port = build_model_from_config(path, device="meta").to_empty(device="cpu")
    port.load_state_dict(state)
    return port, ref_build.build(path, state, "cpu")


def _batch(inputs):
    return traffic.make_pool(dict(TRAFFIC, inputs=inputs), SEED, "cpu")[0]


@pytest.mark.parametrize("inputs,lidar", [(["img", "points"], True),
                                          (["points"], True),
                                          (["img"], True), (["img"], False)],
                         ids=["LC", "L", "C-on-LC", "C"])
def test_predict_matches_the_port(tmp_path, inputs, lidar):
    port, ref = _models(tmp_path, lidar)
    batch = _batch(inputs)
    got, want = check.Capture(port, forced=True), check.Capture(ref)
    got.arm(0)
    out = port.predict(batch)
    want.arm(0)
    with torch.no_grad():
        ref(batch)
    numbers = check.compare(got.records[0], want.records[0], 2)
    numbers.update(check.forced(ref, got.records[0], "cpu"))
    assert {"fused", "decoder", "cls", "box"} <= set(numbers)
    assert ("img_feat" in numbers) == ("img" in inputs)
    assert ("pts_feat" in numbers) == ("points" in inputs)
    assert max(numbers.values()) <= 1e-6, numbers
    with torch.inference_mode():
        ref_out = ref.predict(batch)
    for k in ("bboxes", "scores", "labels"):
        torch.testing.assert_close(ref_out[k], out[k], rtol=1e-6, atol=1e-6)


def test_lc_losses_and_gradients_match_the_port(tmp_path):
    port, ref = _models(tmp_path)
    batch = _batch(["img", "points"])
    losses = {}
    for name, m in (("port", port), ("ref", ref)):
        m.requires_grad_(True)
        out = m.loss(batch, m(batch))
        sum(out.values()).backward()
        losses[name] = out
    assert losses["port"].keys() == losses["ref"].keys()
    for k in losses["port"]:
        torch.testing.assert_close(losses["ref"][k], losses["port"][k],
                                   rtol=1e-6, atol=1e-7)
    ref_params = dict(ref.named_parameters())
    n = 0
    for name, p in port.named_parameters():
        g, r = p.grad, ref_params[name].grad
        assert (g is None) == (r is None), name
        if g is not None:
            torch.testing.assert_close(r, g, rtol=1e-5,
                                       atol=1e-6 * float(g.abs().max()) + 1e-12)
            n += 1
    assert n > 100
