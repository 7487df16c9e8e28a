"""The program's own spans (`repro_torch.trace`) for the metric readers.

The program records spans while a `torch.profiler` runs, so a traced run
holds those of its traced sub-window when the metrics are read. They are
placed on the sub-window by its end: `ctx.window[1]` is taken just before
the sub-window's closing mark, so the sub-window opens at
`ctx.window[1] - ctx.trace.window_s` on the host's `perf_counter` clock,
which the program's spans are stamped on too.

The trace's device clock drifts against the host's: in four traced runs
on an H100 its CUDA events agreed with its own host events for the first
0.3-0.55 s, then ended 1.9, 3.3, 6.3 and 13.2 ms off them (either way) by
the end of the 3.2 s sub-window, while the program's spans kept within
0.03-0.75 ms of the host events they enclose. Each `engine.readback` span
ends just after the device-to-host copy it waited for, so `clock_shift`
follows the drift through the sub-window's copies and readbacks, and each
idle interval is moved whole onto the host's clock before it is
attributed, keeping its length on the trace's clock.

A checkout whose program has no tracer reads nothing here (None).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from pice_bench import tracing

# what the host was doing while the device idled, by the innermost
# host-blocking span around it; every other span, and none, is "serve"
KIND = {"engine.step": "plan", "engine.plan": "plan",
        "engine.commit": "plan", "engine.readback": "plan",
        "engine.admit": "plan", "engine.ingest": "launch",
        "engine.decode": "launch", "engine.prefix": "launch"}
KINDS = ("plan", "launch", "serve")


def program_spans() -> Optional[list]:
    """The program's finished spans, or None without a tracer."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    return trace.spans()


def attribute(idle: List[tuple], host: List[tuple]) -> Dict[str, float]:
    """Seconds of the `idle` intervals [(start, end)] by KIND of the
    innermost of the nested `host` intervals [(start, end, name)] over each
    part of them: an interval split between spans is split in proportion,
    and where two intervals overlap each counts."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    events = []
    for i, (s, e, _) in enumerate(host):
        events += [(s, 1, i), (e, 0, i)]
    for s, e in idle:
        events += [(s, 3, 1), (e, 2, -1)]
    events.sort()
    out = dict.fromkeys(KINDS, 0.0)
    stack: List[int] = []
    depth, prev = 0, None
    for t, what, x in events:
        if depth and t > prev:
            name = host[stack[-1]][2] if stack else ""
            out[KIND.get(name, "serve")] += depth * (t - prev)
        prev = t
        if what == 1:
            stack.append(x)
        elif what == 0:
            stack.remove(x)
        else:
            depth += x
    return out


def clock_shift(ctx, done) -> List[tuple]:
    """Knots [(device time, shift)] of the shift that puts the trace's
    device times on the host's clock, both in seconds from the sub-window's
    opening: between knots the shift is interpolated, beyond them held
    (none without 8 readbacks paired). A readback returns once its
    device-to-host copy is done, and no other copy ends while the host
    waits in it: each `engine.readback` span should hold one copy's end
    in its last 2 ms. The hinge shift r * max(t - t0, 0) (the clocks
    agree when the profiler starts; r within 20 ms a second, t0 within
    1.5 s) that pairs the most readbacks so pairs them; a pair's offset is
    the span's end less its copy's, and the running median of up to 9
    offsets centred on each pair, less the median of the first 5 (the
    host's wake-up after a copy, while the clocks still agree), is the
    shift."""
    t = ctx.trace
    lo = ctx.window[1] - t.window_s
    copies = np.sort(np.array([s + d for name, s, d in t.kernels
                               if "Memcpy DtoH" in name]))
    ends = np.sort(np.array([sp.end / 1e9 - lo for sp in done
                             if sp.name == "engine.readback"]))
    if len(copies) < 8 or len(ends) < 8:
        return []

    def paired(r, t0):
        """Each readback's copy under the hinge (r, t0), or -1."""
        on_host = copies + r * np.maximum(copies - t0, 0.0)
        k = np.searchsorted(on_host, ends, side="right") - 1
        ok = (k >= 0) & (on_host[np.maximum(k, 0)] >= ends - 2e-3)
        return np.where(ok, k, -1)

    best = max(((int((paired(r, t0) >= 0).sum()), -abs(r), r, t0)
                for r in np.arange(-0.02, 0.02001, 0.00025)
                for t0 in np.arange(0.0, 1.5001, 0.05)))
    _, _, r, t0 = best
    k = paired(r, t0)
    c, e = copies[k[k >= 0]], ends[k >= 0]
    n = len(c)
    if n < 8:
        return []
    off = e - c
    lag = float(np.median(off[:5]))
    return [(float(c[i]), float(np.median(off[i - h:i + h + 1])) - lag)
            for i, h in ((i, min(4, i, n - 1 - i)) for i in range(n))]


def shifted(times: List[float], knots: List[tuple]) -> List[float]:
    """Device times put on the host's clock by `clock_shift`'s knots."""
    if not knots:
        return list(times)
    xs, ds = zip(*knots)
    return list(np.asarray(times) + np.interp(times, xs, ds))


def idle_by_kind(ctx) -> Optional[Dict[str, float]]:
    """Seconds of the traced sub-window with no device operation, by what
    the host was doing (KIND); None without a device trace or without
    host-blocking program spans in the sub-window."""
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    done = program_spans()
    if done is None:
        return None
    lo, hi = ctx.window[1] - t.window_s, t.window_s
    host = []
    for s in done:
        a, b = s.start / 1e9 - lo, s.end / 1e9 - lo
        if not s.awaits and b > 0 and a < hi:
            host.append((max(a, 0.0), min(b, hi), s.name))
    if not host:
        return None
    busy = tracing._union([(s, s + d) for _, s, d in t.kernels])
    idle, cur = [], 0.0
    for s, e in busy:
        if s > cur:
            idle.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        idle.append((cur, hi))
    # each idle interval is moved whole by the shift at its middle, so it
    # keeps its length and the kinds sum to `device_idle_share`
    mids = shifted([(s + e) / 2 for s, e in idle], clock_shift(ctx, done))
    return attribute([(m - (e - s) / 2, m + (e - s) / 2)
                      for m, (s, e) in zip(mids, idle)], host)


def idle_share(ctx, kind: str) -> Optional[float]:
    """The sub-window's share with no device operation while the host was
    in `kind` work, in %."""
    by = idle_by_kind(ctx)
    return None if by is None else 100.0 * by[kind] / ctx.trace.window_s


def span_ms(ctx, name: str) -> Optional[List[float]]:
    """Durations in ms of the program's spans called `name` that ended in
    the window (None without a tracer)."""
    done = program_spans()
    if done is None:
        return None
    t0, t1 = ctx.window
    return [(s.end - s.start) / 1e6 for s in done
            if s.name == name and t0 <= s.end / 1e9 <= t1]
