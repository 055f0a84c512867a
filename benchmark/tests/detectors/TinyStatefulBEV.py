"""The tiny stateful detector of ``benchmark/tests/stateful.py``
(``model.type = 'TinyStatefulBEV'``), for the harness's tests: a detector
file found by type like any other, UniBEV's file with the state added to
what the check compares (``history``, the aligned previous BEV the queries
add) and the port built from the test's own class."""

from __future__ import annotations

import torch

from benchmark.reference import build as ref_build
from benchmark.run import load_file
from benchmark.tests.stateful import Reference as REFERENCE  # noqa: F401
from benchmark.tests.stateful import port_class

_unibev = load_file("detectors", "UniBEV")

CAPTURES = dict(_unibev.CAPTURES, history=("history", lambda out, args: out))
FORCED = _unibev.FORCED
EXACT = _unibev.EXACT
PER_FORWARD = _unibev.PER_FORWARD
LAYERS = _unibev.LAYERS
OPS = _unibev.OPS
REF_OPS = _unibev.REF_OPS
of_model = _unibev.of_model
forced = _unibev.forced
describe = _unibev.describe
init_rules = _unibev.init_rules
FAULTS = _unibev.FAULTS


def build_port(config_file: str, device, train: bool):
    """The port's tiny stateful model of ``config_file``, float32, eval."""
    with torch.device("meta"):
        model = port_class()(**ref_build.model_cfg(config_file))
    if torch.device(device).type != "meta":
        model = model.to_empty(device=device)
    return model.eval().requires_grad_(False)


def served_dtype(config_file: str) -> torch.dtype:
    return torch.float32
