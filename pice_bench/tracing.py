"""The traced sub-window: `torch.profiler` over the last seconds of the
window, reduced to the device's operations, its busy time, and its idle
gaps labelled by the harness span the host was in.

Two markers (`pice_bench.mark`) bound the sub-window on the trace's own
clock; host spans are `pice_bench.<role>.<call>` annotations, made only
while the profiler runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import List, Optional, Tuple

import torch

MARK = "pice_bench.mark"
PREFIX = "pice_bench."


def annotate(on: bool, name: str):
    """A host span in the trace while tracing, else nothing."""
    if on:
        return torch.profiler.record_function(PREFIX + name)
    return contextlib.nullcontext()


def start(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    with torch.profiler.record_function(MARK):
        pass
    return prof


def warm(device: torch.device) -> None:
    """Start and stop a profiler once in set-up: the first start in a
    process sets up the tracer and holds the event loop for seconds, which
    inside the window would stall the traffic before the traced
    sub-window."""
    prof = start(device)
    prof.stop()


def _ns(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.duration_ns()
    return int(e.start_us() * 1000), int(e.duration_us() * 1000)


def short_name(name: str, cap: int = 160) -> str:
    """A kernel's name without its argument list (cut at the first "(" at
    template depth 0) and without a leading "void "."""
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] != " ":
            name = name[:i]
            break
    if name.startswith("void "):
        name = name[5:]
    return name[:cap]


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[list] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]   # (name, start s, seconds)
    gaps: List[Tuple[str, float]]             # (host span, idle seconds)
    calls: list                               # the harness's model calls

    def breakdown(self) -> dict:
        by = defaultdict(float)
        for name, _, dur in self.kernels:
            by[short_name(name)] += dur
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        idle = defaultdict(float)
        for name, dur in self.gaps:
            idle[name] += dur
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def stop(prof, calls: list) -> Optional[Trace]:
    """End the sub-window and reduce the trace."""
    with torch.profiler.record_function(MARK):
        pass
    prof.stop()
    events = prof.profiler.kineto_results.events()
    marks = sorted(_ns(e)[0] for e in events if e.name() == MARK)
    if len(marks) < 2:
        return None
    lo, hi = marks[0], marks[-1]
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        s, d = _ns(e)
        if e.name().startswith(PREFIX):
            # a host span, also mirrored on the device's timeline
            if e.device_type() != cuda and e.name() != MARK:
                host.append((e.name()[len(PREFIX):], s, s + d))
            continue
        if e.device_type() == cuda:
            s, t = max(s, lo), min(s + d, hi)
            if t > s:
                dev.append((e.name(), s, t))
    busy = _union([(s, t) for _, s, t in dev])
    idle, cur = [], lo
    for s, t in busy:
        if s > cur:
            idle.append((cur, s))
        cur = max(cur, t)
    if cur < hi:
        idle.append((cur, hi))
    gaps = []
    for s, t in idle:
        mid = (s + t) / 2
        inside = [h for h in host if h[1] <= mid <= h[2]]
        # the innermost span the host was in, or the event loop between
        name = min(inside, key=lambda h: h[2] - h[1])[0] if inside \
            else "loop"
        gaps.append((name, (t - s) / 1e9))
    return Trace(window_s=(hi - lo) / 1e9,
                 busy_s=sum(t - s for s, t in busy) / 1e9,
                 kernels=[(n, (s - lo) / 1e9, (t - s) / 1e9)
                          for n, s, t in dev],
                 gaps=gaps, calls=list(calls))
