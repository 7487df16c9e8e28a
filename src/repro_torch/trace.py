"""Host spans of the serving path, on one clock with the device trace.

A span is a named interval of the host's `time.perf_counter_ns()` with its
parent span's id, the answer's request id and a small dict of attributes
(the engine's per-step counters, for instance). Parents and request ids
pass through a `contextvars.ContextVar`, so they follow asyncio tasks.
Finished spans go into a bounded ring (`RING` entries; `spans()` returns a
snapshot).

Two kinds of span:

  * `span(name)`, a context manager, for a section that blocks the host
    (an engine step, its readback, a planning pass). It is the parent of
    the spans opened inside it. With `awaits=True` the block may await: a
    pipeline answer or its cloud sketch, whose children run in other
    coroutines and tasks.
  * `begin(name)` / `end(span)` for an interval that starts and ends in
    different tasks or driver iterations (a request waiting for a slot).
    It is no one's parent.

Recording is on after `enable()`, or while a `torch.profiler` runs. When
off, a host-blocking span site costs one flag check and allocates
nothing: `span()` returns a shared no-op context whose `as` target is
None, `begin()` returns None, and callers build attribute values only
under `if sp is not None`. A span that awaits keeps its start stamp while
off (one small object, a few an answer) and is recorded if recording is
on when it ends, without a parent: a pipeline's sketch outlasts a
profiler window of seconds, and would otherwise never be seen whole. The
tracer itself calls no `record_function`, NVTX, CUDA event or device
synchronisation: its spans never appear on the device's timeline, where a
profiler would count them as device work.

One clock with the profiler: at each switch to on the tracer takes the
pair (`perf_counter_ns()`, `time.time_ns()`), and `export_chrome(path)`
writes every span as a Chrome-trace "X" event in microseconds on the Unix
epoch clock that kineto stamps its host and CUDA events with. An operator
takes both files over one interval,

    with torch.profiler.profile(activities=[CPU, CUDA]) as prof:
        ...serve...
    prof.export_chrome_trace("device.json")
    trace.export_chrome("host.json")

and opens them side by side in Perfetto: each idle gap on the card lines
up with the host span that made it. Host-blocking spans take one lane per
engine (`engine` attribute, own or a parent's) and one for the pipeline;
spans that cross awaits overlap, so each answer's take a lane of their
own.
"""
from __future__ import annotations

import collections
import contextvars
import itertools
import json
import os
import time
from typing import Dict, List, Optional

from torch.autograd import _profiler_enabled

RING = 1 << 18

_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_current: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_trace_span", default=None)
_enabled = False
_was_on = False
# time.time_ns() - time.perf_counter_ns(), taken at the last switch to on
_epoch_offset_ns = 0


class Span:
    """One span; also the context manager that `span()` returns."""
    __slots__ = ("name", "id", "parent", "req_id", "start", "end", "attrs",
                 "awaits", "_token")

    def __init__(self, name: str, attrs: Optional[dict], awaits: bool,
                 req_id):
        parent = _current.get()
        self.name = name
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.req_id = req_id if req_id is not None else (
            parent.req_id if parent is not None else None)
        self.attrs = dict(attrs) if attrs else {}
        self.awaits = awaits
        self.start = self.end = 0
        self._token = None

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, kind, exc, tb) -> None:
        self.end = time.perf_counter_ns()
        _current.reset(self._token)
        self._token = None
        if kind is not None:
            self.attrs["error"] = kind.__name__
        _ring.append(self)


class _Off:
    """The span site's context while recording is off."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, kind, exc, tb) -> None:
        return None


_OFF = _Off()


class _Await:
    """A span that awaits, begun while recording is off."""
    __slots__ = ("name", "req_id", "start")

    def __init__(self, name: str, req_id):
        self.name = name
        self.req_id = req_id

    def __enter__(self) -> None:
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, kind, exc, tb) -> None:
        if on():
            sp = Span(self.name, None, True, self.req_id)
            sp.start = self.start
            sp.end = time.perf_counter_ns()
            if kind is not None:
                sp.attrs["error"] = kind.__name__
            _ring.append(sp)


def _sync_clock() -> None:
    global _epoch_offset_ns
    p = time.perf_counter_ns()
    e = time.time_ns()
    _epoch_offset_ns = e - (p + time.perf_counter_ns()) // 2


def on() -> bool:
    """Whether spans are recorded now: after `enable()`, or while a
    `torch.profiler` runs."""
    global _was_on
    if _enabled or _profiler_enabled():
        if not _was_on:
            _was_on = True
            _sync_clock()
        return True
    _was_on = False
    return False


def enable() -> None:
    global _enabled
    _enabled = True
    on()


def disable() -> None:
    global _enabled
    _enabled = False


def span(name: str, attrs: Optional[dict] = None, *, awaits: bool = False,
         req_id=None):
    """A span around a `with` block, the parent of the spans opened in
    it; `awaits=True` when the block awaits. The `as` target is the Span,
    or None while recording is off."""
    if on():
        return Span(name, attrs, awaits, req_id)
    return _Await(name, req_id) if awaits else _OFF


def begin(name: str, attrs: Optional[dict] = None) -> Optional[Span]:
    """Open a span that `end()` closes, possibly in another task; it is
    not made the parent of later spans. None while recording is off."""
    if not on():
        return None
    sp = Span(name, attrs, True, None)
    sp.start = time.perf_counter_ns()
    return sp


def end(sp: Optional[Span]) -> None:
    """Close a span `begin()` opened (None: nothing)."""
    if sp is not None:
        sp.end = time.perf_counter_ns()
        _ring.append(sp)


def spans() -> List[Span]:
    """A snapshot of the finished spans, oldest first."""
    return list(_ring)


def clear() -> None:
    _ring.clear()


def _lane(sp: Span, by_id: Dict[int, Span]) -> str:
    s = sp
    while s is not None:
        engine = s.attrs.get("engine")
        if engine is not None:
            return f"engine {engine}"
        s = by_id.get(s.parent)
    return f"answer {sp.req_id}" if sp.awaits else "pipeline"


def export_chrome(path) -> int:
    """Write the finished spans to `path` as Chrome-trace JSON ("X"
    events, microseconds on the Unix epoch clock); returns the number of
    spans written."""
    done = spans()
    by_id = {s.id: s for s in done}
    lanes: Dict[str, int] = {}
    pid = os.getpid()
    events = []
    for s in done:
        lane = _lane(s, by_id)
        tid = lanes.setdefault(lane, len(lanes) + 1)
        args = {"id": s.id, "parent": s.parent, "req_id": s.req_id}
        args.update(s.attrs)
        events.append({"name": s.name, "ph": "X", "pid": pid, "tid": tid,
                       "ts": (s.start + _epoch_offset_ns) / 1e3,
                       "dur": (s.end - s.start) / 1e3, "args": args})
    for lane, tid in lanes.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": lane}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(done)
