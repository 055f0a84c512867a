"""The port's timing helpers (``unibev_tpu_torch/utils/timer.py``): spans
recorded only while ``recording()`` is on, with their parents, call ids
and self times; the tiny detector's outputs with recording on and off;
``profile_trace``'s chrome trace with the span row on the profiler's clock;
and the split of the card's idle time over the host's spans
(``idle_by_layer``)."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from unibev_tpu_torch.flagship import (build_model, tiny_batch,
                                       tiny_bevformer_cfg, tiny_model_cfg)
from unibev_tpu_torch.utils import timer
from unibev_tpu_torch.utils.timer import (NO_LAYER, idle_by_layer,
                                          profile_trace, recording, span,
                                          spanned)


def test_spans_off_record_nothing():
    with recording() as rec:
        pass
    off = span("predict")
    assert off is span("kernel:msda_fwd")        # one shared no-op context
    with span("predict"):
        with span("head"):
            x = torch.ones(3) * 2
    assert torch.equal(x, torch.full((3,), 2.0))
    assert rec.spans() == [] and rec.by_call() == {}


def test_spans_on_keep_parent_call_and_self_time():
    with recording() as rec:
        with span("setup"):
            pass
        for _ in range(2):
            with span("predict"):
                with span("head"):
                    time.sleep(0.002)
                    with span("bev_encoders"):
                        time.sleep(0.003)
                    with span("kernel:msda_fwd"):
                        time.sleep(0.001)
                time.sleep(0.001)
    assert span("predict") is span("head")        # off again
    spans = rec.spans()
    names = [s.name for s in spans]
    assert names == ["setup"] + ["predict", "head", "bev_encoders",
                                 "kernel:msda_fwd"] * 2
    assert [s.parent for s in spans] == [-1, -1, 1, 2, 2, -1, 5, 6, 6]
    assert [s.call for s in spans] == [None, 1, 1, 1, 1, 2, 2, 2, 2]
    assert {s.thread for s in spans} == {threading.get_ident()}
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)
    own = rec.self_ns()
    dur = [s.end_ns - s.start_ns for s in spans]
    for p, h, b, k in ((1, 2, 3, 4), (5, 6, 7, 8)):
        # a kernel span is a leaf and no layer: the head keeps its time
        assert own[h] == dur[h] - dur[b]
        assert own[p] == dur[p] - dur[h]
        assert own[k] == dur[k] and own[b] == dur[b]
        assert own[h] >= 3_000_000 - 1 and own[p] >= 1_000_000 - 1
    calls = rec.by_call()
    assert sorted(calls) == [1, 2]
    for rows in calls.values():
        assert [s.name for s, _ in rows] == names[1:5]
        # the layers' self times and predict's glue make up the call
        assert sum(o for s, o in rows if timer.is_layer(s.name)) \
            == rows[0][0].end_ns - rows[0][0].start_ns
    with recording() as again:
        pass
    assert again.spans() == [] and rec.spans() == spans


def test_spans_of_each_thread_nest_apart():
    barrier = threading.Barrier(2)

    def work():
        with span("predict"):
            barrier.wait(timeout=10)
            with span("head"):
                barrier.wait(timeout=10)

    with recording() as rec:
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    spans = rec.spans()
    assert len(spans) == 4 and all(s.end_ns for s in spans)
    for s in spans:
        if s.name == "head":
            parent = spans[s.parent]
            assert parent.name == "predict" and parent.thread == s.thread
            assert s.call == parent.call
    assert sorted(s.call for s in spans if s.name == "predict") == [1, 2]


def test_recordings_do_not_nest():
    with recording():
        with pytest.raises(RuntimeError):
            with recording():
                pass
    assert span("x") is span("y")


def test_predict_is_bit_identical_with_recording_on_and_off():
    model = build_model(tiny_model_cfg(use_lidar=True), "cpu", seed=0)
    batch = tiny_batch(np.random.RandomState(0))
    off = model.predict(batch)
    with recording() as rec:
        on = model.predict(batch)
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k
    calls = rec.by_call()
    assert list(calls) == [1]
    rows = calls[1]
    names = [s.name for s, _ in rows]
    assert names[0] == "predict" and rows[0][0].parent == -1
    for layer in ("camera_backbone", "lidar_branch", "bev_encoders", "head"):
        assert layer in names, layer
    assert names.count("head") == 2 and names.count("bev_encoders") == 2
    for s, _ in rows:
        if s.name == "bev_encoders":
            assert rec.spans()[s.parent].name == "head"
    # the layers' self times and predict's glue make up the predict span
    # exactly; the sparse wrappers that hold the CPU's plain path too open
    # their kernels' spans here
    assert sum(o for s, o in rows if timer.is_layer(s.name)) \
        == rows[0][0].end_ns - rows[0][0].start_ns
    kernels = {s.name for s, _ in rows if not timer.is_layer(s.name)}
    assert kernels == {"kernel:sparse_nbr", "kernel:sparse_conv"}
    for s, _ in rows:
        if s.name.startswith(timer.KERNEL):
            assert rec.spans()[s.parent].name == "lidar_branch"


def _bevformer_frames():
    """Two frames of one scene for the tiny BEVFormer: the tiny batch's
    images, 4 m forward and a 3 degree turn between them, 800 m out."""
    batch = tiny_batch(np.random.RandomState(0))
    bus = torch.zeros(2, 1, 18, dtype=torch.float64)
    bus[:, 0, 0] = torch.tensor([800.0, 804.0], dtype=torch.float64)
    bus[:, 0, 16] = torch.tensor([0.5, 0.5 + np.radians(3.0)],
                                 dtype=torch.float64)
    bus[:, 0, 17] = torch.rad2deg(bus[:, 0, 16])
    return [dict(img=batch["img"], lidar2img=batch["lidar2img"],
                 can_bus=bus[k], scene_id=torch.tensor([7]))
            for k in range(2)]


def test_bevformer_predict_records_its_spans_and_is_bit_identical():
    """The tiny BEVFormer's second frame (with history: the alignment
    rotates and shifts) records ``bev_align`` once and
    ``temporal_attention`` once a layer, inside ``bev_encoders`` and
    ``head``; recording changes no bit."""
    model = build_model(tiny_bevformer_cfg(), "cpu", seed=0,
                        kind="BEVFormer")
    frames = _bevformer_frames()
    off = [model.predict(b) for b in frames]
    model.history.reset()
    with recording() as rec:
        on = [model.predict(b) for b in frames]
    for a, b in zip(off, on):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert on[1]["history"].tolist() == [True]
    calls = rec.by_call()
    assert list(calls) == [1, 2]
    spans = rec.spans()
    for call in (1, 2):
        rows = calls[call]
        names = [s.name for s, _ in rows]
        assert names.count("bev_align") == 1
        assert names.count("temporal_attention") == 2
        for s, _ in rows:
            if s.name == "bev_align":
                assert spans[s.parent].name == "head"
            if s.name == "temporal_attention":
                assert spans[s.parent].name == "bev_encoders"


def test_spanned_calls_through_and_records_while_on():
    @spanned("head")
    def f(x, y=1):
        """doc"""
        return x + y

    assert f.__name__ == "f" and f.__doc__ == "doc"
    assert f(1, y=2) == 3
    with recording() as rec:
        with span("predict"):
            assert f(2) == 3
        with pytest.raises(TypeError):
            f()
    assert [(s.name, s.parent, s.call) for s in rec.spans()] == \
        [("predict", -1, 1), ("head", 0, 1), ("head", -1, None)]
    assert all(s.end_ns for s in rec.spans())          # closed on a raise
    assert f(5) == 6 and len(rec.spans()) == 3


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_profile_trace_puts_the_spans_on_the_profilers_clock(tmp_path):
    with profile_trace(str(tmp_path)):
        with recording() as rec:
            with span("matmul"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    row = [e for e in events if e.get("tid") == timer.SPAN_TID]
    assert [e["name"] for e in row if e["ph"] == "X"] == ["matmul"]
    assert any(e["ph"] == "M" and e["args"]["name"] == "spans" for e in row)
    s = next(e for e in row if e["ph"] == "X")
    (s_rec,) = rec.spans()
    assert abs(s["dur"] - (s_rec.end_ns - s_rec.start_ns) / 1e3) < 1e-3
    mm = [e for e in events if e.get("name") == "aten::mm"
          and e.get("ph") == "X"]
    assert len(mm) == 1
    # the span holds the product, within 50 us on the trace's clock
    assert mm[0]["ts"] >= s["ts"] - 50
    assert mm[0]["ts"] + mm[0]["dur"] <= s["ts"] + s["dur"] + 50


def test_profile_trace_writes_no_span_row_for_a_recording_begun_outside(
        tmp_path):
    with recording():
        with profile_trace(str(tmp_path)):
            with span("matmul"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert not [e for e in events if e.get("tid") == timer.SPAN_TID]


def test_idle_attribution_splits_a_gap_over_the_spans_it_crosses():
    # window [0, 100); busy [0, 10), [40, 60), [90, 95)
    busy = [(0, 10), (40, 60), (90, 95)]
    spans = [(5, 30, "camera_backbone"),            # the gap 10-40 crosses it
             (30, 80, "head"), (50, 70, "bev_encoders")]
    idle = idle_by_layer(0, 100, busy, spans)
    assert idle == {"camera_backbone": 20, "head": 10 + 10,
                    "bev_encoders": 10, NO_LAYER: 10 + 5}
    # the entry's span and kernel spans are no layers: their time is
    # NO_LAYER's or the enclosing layer's
    more = spans + [(0, 100, "predict"), (55, 58, "kernel:msda_fwd")]
    assert idle_by_layer(0, 100, busy, more) == idle
    assert sum(idle.values()) == 100 - 10 - 20 - 5


def test_idle_attribution_clips_to_the_window_and_sums_to_its_idle_time():
    rng = np.random.RandomState(3)
    lo, hi = 1_000, 9_000
    edges = np.sort(rng.choice(np.arange(0, 10_000), 40, replace=False))
    busy = [(int(a), int(b)) for a, b in zip(edges[::2], edges[1::2])]
    # spans nest as one thread's do: calls, and layers inside them
    spans = []
    for start in range(0, 10_000, 2_000):
        spans.append((start + 100, start + 1_900, "head"))
        spans.append((start + 300, start + 900, "bev_encoders"))
        spans.append((start + 1_000, start + 1_400, "bev_encoders"))
    idle = idle_by_layer(lo, hi, busy, spans)
    clipped = sum(max(0, min(b, hi) - max(a, lo)) for a, b in busy)
    assert sum(idle.values()) == (hi - lo) - clipped
    assert set(idle) <= {"head", "bev_encoders", NO_LAYER}
    assert all(v >= 0 for v in idle.values())
    # no busy time: each label holds its own time in the window
    idle = idle_by_layer(lo, hi, [], spans)
    assert idle["bev_encoders"] == 4 * 1_000
    assert idle["head"] == 4 * (1_800 - 1_000)
    assert idle[NO_LAYER] == (hi - lo) - 4 * 1_800
