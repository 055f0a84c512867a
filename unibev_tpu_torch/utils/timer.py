"""Timing helpers: spans at the port's layer boundaries, and
``profile_trace``, a ``torch.profiler`` chrome trace of a block.

A span marks where the host works for one layer: ``with span(name):``
around a block, or ``@spanned(name)`` on a function.  The port opens them
at its layer boundaries: ``predict`` (the entry, ``UniBEV.predict``),
``camera_backbone``, ``lidar_branch``, ``bev_encoders``, ``head`` and, on
each hand kernel's wrapper, ``kernel:<name>`` under the name
``ops._build.launches`` counts it by.  A kernel span covers the whole
wrapper: ``sparse_nbr``, ``sparse_conv``, ``sparse_inv_nbr`` and
``sparse_conv_wgrad`` hold the plain CPU path too, and open it there.

Recording is off unless a caller turns it on with :func:`recording`.  Off,
a span checks one module-level name: ``span`` returns a shared no-op
context and a ``spanned`` function calls straight through, with no clock
read, no allocation and no profiler range.  On, each span is kept in
memory (name, ``time.perf_counter_ns`` start and end, the index of the
enclosing span on its thread, the thread, and a call id: each ``predict``
span that opens outside any span starts a new call, and the spans inside
it share its id).  A span never waits for the card and never reads a
tensor.

``recording()`` opens with one ``torch.profiler`` range,
``CLOCK_MARKER``, and reads ``perf_counter_ns`` as it closes: inside a
profiler session the range's end and that read pair the two clocks
(:meth:`Recorder.profiler_offset_ns`).  ``profile_trace`` uses the pairing
to write the spans of a recording made inside its block into the chrome
trace, as a row of their own.  :func:`idle_by_layer` splits the card's
idle time over the layer spans the host was in, given the card's busy
intervals on the same clock.

The JAX module's ``run_time`` (a decorator that synchronizes and prints on
every call) and ``start_profiler_server`` have no counterpart here.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import (Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

ENTRY = "predict"
KERNEL = "kernel:"
# the idle time's label where the host is in no layer span but the entry
NO_LAYER = "entry"
CLOCK_MARKER = "unibev_span_clock"
# the chrome trace's thread id of the span row (``profile_trace``)
SPAN_TID = 0x5350414E


class Span(NamedTuple):
    """One recorded span; ``end_ns`` is 0 while it is open."""
    name: str
    start_ns: int
    end_ns: int
    parent: int              # index of the enclosing span, -1 at a root
    thread: int
    call: Optional[int]      # the call id, None outside a ``predict`` call


def is_layer(name: str) -> bool:
    """Every span but a kernel's is a layer; kernel spans are leaves."""
    return not name.startswith(KERNEL)


class Recorder:
    """The spans of one :func:`recording`, in the order they opened."""

    def __init__(self):
        self._rows: List[list] = []
        self._stacks: Dict[int, List[int]] = {}
        self._ids = itertools.count(1)
        self.marker_ns = 0       # perf_counter_ns as CLOCK_MARKER closed

    def _open(self, name: str) -> int:
        thread = threading.get_ident()
        stack = self._stacks.setdefault(thread, [])
        parent = stack[-1] if stack else -1
        if parent >= 0:
            call = self._rows[parent][5]
        else:
            call = next(self._ids) if name == ENTRY else None
        index = len(self._rows)
        self._rows.append([name, time.perf_counter_ns(), 0, parent, thread,
                           call])
        stack.append(index)
        return index

    def _close(self, index: int) -> None:
        self._rows[index][2] = time.perf_counter_ns()
        self._stacks[self._rows[index][4]].pop()

    def spans(self) -> List[Span]:
        return [Span(*r) for r in self._rows]

    def self_ns(self) -> List[int]:
        """Each closed span's duration less that of its closed child layer
        spans (0 for an open span)."""
        spans = self.spans()
        out = [s.end_ns - s.start_ns if s.end_ns else 0 for s in spans]
        for s in spans:
            if s.parent >= 0 and s.end_ns and is_layer(s.name):
                out[s.parent] -= s.end_ns - s.start_ns
        return out

    def by_call(self) -> Dict[int, List[Tuple[Span, int]]]:
        """{call id: [(span, self ns)]} of the closed spans of each call."""
        out: Dict[int, List[Tuple[Span, int]]] = {}
        for s, own in zip(self.spans(), self.self_ns()):
            if s.call is not None and s.end_ns:
                out.setdefault(s.call, []).append((s, own))
        return out

    def profiler_offset_ns(self, marker_end_ns: float) -> float:
        """What to add to a span's time to put it on the profiler's clock,
        given where the profiler saw ``CLOCK_MARKER`` end.  The range's end
        is paired with the read just after it, since a process's first
        range can take a millisecond to start."""
        return marker_end_ns - self.marker_ns


class _Open:
    __slots__ = ("rec", "name", "index")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.index = self.rec._open(self.name)

    def __exit__(self, *exc):
        self.rec._close(self.index)
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on: Optional[Recorder] = None      # the recorder while recording is on
_last: Optional[Recorder] = None    # the latest recording's


def span(name: str):
    """A context that records the block as span ``name`` while recording
    is on, and does nothing otherwise."""
    rec = _on
    if rec is None:
        return _OFF
    return _Open(rec, name)


def spanned(name: str) -> Callable:
    """Decorator: each call of the function is span ``name`` while
    recording is on; otherwise the call goes straight through."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            rec = _on
            if rec is None:
                return fn(*args, **kwargs)
            with _Open(rec, name):
                return fn(*args, **kwargs)
        return inner

    return wrap


@contextlib.contextmanager
def recording():
    """Record spans in the block; yields a new :class:`Recorder` (the
    previous recording's spans are dropped).  Recordings do not nest."""
    global _on, _last
    if _on is not None:
        raise RuntimeError("span recording is already on")
    rec = Recorder()
    with torch.profiler.record_function(CLOCK_MARKER):
        pass
    rec.marker_ns = time.perf_counter_ns()
    _last = rec
    _on = rec
    try:
        yield rec
    finally:
        _on = None


def idle_by_layer(lo: int, hi: int, busy: Sequence[Tuple[int, int]],
                  spans: Iterable[Tuple[int, int, str]]) -> Dict[str, int]:
    """{label: idle ns} over the window [lo, hi]: the time in no interval of
    ``busy`` (the card's, sorted and disjoint), each instant under the
    innermost layer span of ``spans`` (start, end, name on the same clock;
    properly nested, as one thread's are) open then, or ``NO_LAYER`` under
    none (the entry's own span and kernel spans are no layers here).  The
    parts sum to the window's idle time."""
    spans = [r for r in spans if r[2] != ENTRY and is_layer(r[2])]
    # the window cut into pieces, each under one label
    pieces: List[Tuple[int, int, str]] = []

    def put(a: int, b: int, label: str) -> None:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            pieces.append((a, b, label))
    t = lo
    stack: List[Tuple[int, str]] = []
    for s, e, label in sorted(spans, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            put(t, end, top)
            t = max(t, end)
        put(t, s, stack[-1][1] if stack else NO_LAYER)
        t = max(t, s)
        stack.append((e, label))
    while stack:
        end, top = stack.pop()
        put(t, end, top)
        t = max(t, end)
    put(t, hi, NO_LAYER)
    # each piece less the busy time in it
    out: Dict[str, int] = {}
    i = 0
    for a, b, label in pieces:
        idle = b - a
        while i < len(busy) and busy[i][1] <= a:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < b:
            idle -= min(b, busy[j][1]) - max(a, busy[j][0])
            j += 1
        out[label] = out.get(label, 0) + idle
    return out


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _span_row(events: List[dict], rec: Recorder) -> List[dict]:
    """Chrome trace events of ``rec``'s closed spans on the trace's clock,
    paired through the last ``CLOCK_MARKER`` of ``events``; none where the
    trace holds no marker (the recording began outside it)."""
    marks = [e for e in events if e.get("name") == CLOCK_MARKER
             and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not marks:
        return []
    end_us = marks[-1]["ts"] + marks[-1]["dur"]
    offset_us = rec.profiler_offset_ns(end_us * 1e3) / 1e3
    pid = marks[-1]["pid"]
    row = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TID,
            "args": {"name": "spans"}}]
    for s in rec.spans():
        if s.end_ns:
            row.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                        "tid": SPAN_TID, "ts": s.start_ns / 1e3 + offset_us,
                        "dur": (s.end_ns - s.start_ns) / 1e3,
                        "args": {"call": s.call, "parent": s.parent}})
    return row


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where it is
    up), written to ``log_dir/trace.json`` for chrome://tracing or
    Perfetto; yields the profiler.  The spans of a :func:`recording` that
    began inside the block go into the trace as a row of their own
    (thread "spans")."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if _last is None:
        return
    with open(path) as f:
        trace = json.load(f)
    row = _span_row(trace.get("traceEvents", []), _last)
    if row:
        trace["traceEvents"].extend(row)
        with open(path, "w") as f:
            json.dump(trace, f)
