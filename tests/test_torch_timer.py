"""The port's timing helpers (``unibev_tpu_torch/utils/timer.py``), as
tests/test_aux.py holds the JAX package's: the ``run_time`` decorator
prints its running average and records it in ``timing_stats``;
``profile_trace`` writes a chrome trace of its block."""

import json
import os

import torch

from unibev_tpu_torch.utils.timer import profile_trace, run_time, timing_stats


def test_run_time_decorator(capsys):
    @run_time("toy_torch")
    def f(x):
        return x * 2

    out = f(torch.ones(4))
    f(torch.ones(4))
    assert torch.equal(out, torch.full((4,), 2.0))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and lines[1].startswith("[toy_torch] avg ")
    assert lines[1].endswith("ms over 2 calls")
    assert timing_stats()["toy_torch"] > 0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
