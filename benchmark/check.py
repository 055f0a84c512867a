"""The correctness check: what the timed path produced, against the plain
reference on the same weights and inputs.

Forward hooks on the port's modules keep, for a sample of the window's
calls drawn from the seed, each layer's output that the detector file
names (``detectors/<model.type>.py``, ``CAPTURES``; copied to the host as
it is produced, on the stream, without waiting), with what its step-by-step
check reads of the port alone (``FORCED``).  After the window the reference
(``reference/``, float32, TF32 off) runs the same batches and the same
hooks give its outputs.  Each number compared is the largest, over the
sampled calls and the samples of each, of one layer's relative L2 error
``|port - ref| / |ref|`` on one sample, or, for the counts the detector
names (``EXACT``), the largest absolute difference; the detector file's
``forced`` adds the numbers of the layers it runs step by step from the
port's own state.  ``limits/<workload>.json`` holds each number's limit.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

# what predict returns, compared row by row
DECODED = ("scores", "labels", "valid", "bboxes")


def per_sample(name: str, t: torch.Tensor, batch: int,
               per_forward) -> torch.Tensor:
    """``t`` as (batch, -1) float32 rows, one a sample; a count of a whole
    forward (``per_forward``) as one row."""
    t = t.float()
    if name in per_forward:
        return t.reshape(1, -1)
    return t.reshape(batch, -1)


class Capture:
    """Forward hooks on a model that keep the outputs of ``captures`` (and
    of ``forced``, where given) while armed, copied to the host without
    waiting: {name: (module path, how to read it from the module's output
    and inputs)}, a detector file's ``CAPTURES`` and ``FORCED``."""

    def __init__(self, model: nn.Module, captures: Dict, forced: Dict = None):
        self.records: Dict[int, Dict[str, torch.Tensor]] = {}
        self._current: Optional[Dict[str, torch.Tensor]] = None
        self._handles = []
        self._what = dict(captures, **(forced or {}))
        modules = dict(model.named_modules())
        paths: Dict[str, List[str]] = {}
        for name, (path, _) in self._what.items():
            if path in modules:
                paths.setdefault(path, []).append(name)
        for path, names in paths.items():
            self._handles.append(modules[path].register_forward_hook(
                self._hook(names)))

    def _hook(self, names: List[str]) -> Callable:
        def hook(module, args, out):
            if self._current is None:
                return
            for name in names:
                t = self._what[name][1](out, args)
                if isinstance(t, torch.Tensor):
                    self._current[name] = t.detach().to("cpu",
                                                        non_blocking=True)
        return hook

    def outputs(self, out: Dict[str, torch.Tensor]) -> None:
        """Keep the armed call's own outputs (their host copies)."""
        if self._current is not None:
            self._current["decoded"] = out

    def arm(self, key: Optional[int]) -> None:
        """Keep the next call's outputs under ``key`` (None: keep none)."""
        self._current = None if key is None else self.records.setdefault(key, {})

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


def compare(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
            batch: int, exact, per_forward) -> Dict[str, float]:
    """Each number of one call: relative L2 error per sample, the largest
    over the samples; counts (``exact``) by their largest absolute
    difference, those of a whole forward (``per_forward``) as one row.  A
    layer the reference ran and the port did not reads infinity."""
    out: Dict[str, float] = {}
    for name, r in want.items():
        if name == "decoded":
            continue
        if name not in got:
            out[name] = float("inf")
            continue
        g = per_sample(name, got[name], batch, per_forward)
        r = per_sample(name, r, batch, per_forward)
        if g.shape != r.shape:
            out[name] = float("inf")
        elif name in exact:
            out[name] = float((g - r).abs().max())
        else:
            err = (g - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)
            out[name] = float(err.max())
    return out


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest over the samples (dim 0) of the relative L2 error."""
    g = got.float().reshape(got.shape[0], -1)
    w = want.float().reshape(want.shape[0], -1)
    return float(((g - w).norm(dim=1) / w.norm(dim=1).clamp(min=1e-30)).max())


def _rows(d: Dict[str, torch.Tensor], b: int, floor: float):
    """Sample ``b``'s decoded rows scored above ``floor``, in one order."""
    rows = torch.cat([d[k][b].float().reshape(d["scores"].shape[1], -1).cpu()
                      for k in DECODED], dim=1).double()
    rows = rows[rows[:, 0] > floor].numpy()
    return rows[np.lexsort(rows.T[::-1])]


def decode_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
               ) -> float:
    """Rows of ``predict``'s output that differ from the reference's
    decoding, over the samples.  Rows tied with the lowest score either
    side kept are left out: top-k may keep any row of such a tie."""
    if not all(k in got for k in DECODED):
        return float("inf")
    diff = 0
    for b in range(want["scores"].shape[0]):
        floor = float(max(got["scores"][b].float().min(),
                          want["scores"][b].float().min()))
        g, w = _rows(got, b, floor), _rows(want, b, floor)
        if g.shape != w.shape:
            diff += abs(g.shape[0] - w.shape[0]) + min(g.shape[0], w.shape[0])
        else:
            diff += int((g != w).any(axis=1).sum())
    return float(diff)


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over the calls."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, number, limit)]): every limited number present and
    within its limit (counts: at most the limit, which is 0)."""
    rows = [(k, numbers.get(k, float("inf")), v) for k, v in sorted(limits.items())]
    correct = all(n == n and n <= lim for _, n, lim in rows)
    return correct, rows


def sample_calls(gen: torch.Generator, within: int, pool: int, count: int
                 ) -> List[int]:
    """``count`` call indices below ``within``, drawn from ``gen``, on
    distinct batches of the pool where the pool allows."""
    order = torch.randperm(within, generator=gen).tolist()
    picked, seen = [], set()
    for i in order:
        if i % pool not in seen or len(seen) >= pool:
            picked.append(i)
            seen.add(i % pool)
        if len(picked) == count:
            break
    return sorted(picked)
