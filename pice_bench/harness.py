"""One run of one cell: build the fleet from the configuration file, offer
the mix's traffic to `PICEPipeline.handle_async` for a window, record
spans around the calls into each layer, read the metrics, and judge the
served tokens against the plain reference.

Everything that belongs to one configuration, mix or metric is found by
name: `configs/<config>.json`, `traffic/<mix>.json`,
`metrics/<metric>.py`, `reference/<family>.py`.
"""
from __future__ import annotations

import asyncio
import contextlib
import contextvars
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import random
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import torch

from pice_bench import tracing
from pice_bench.traffic import generator

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
ROLES = ("cloud", "edge")
# the modules that no process of the benchmark may hold, compared by their
# whole top-level name: JAX, its compiled half, flax, and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the traced sub-window: the last seconds of the window
TRACE_S = 3.0

_request = contextvars.ContextVar("pice_bench_request", default=None)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules(names=None) -> List[str]:
    """The FORBIDDEN top-level names among `names` (default: the modules
    this process holds), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def role_seed(seed: int, role: str) -> int:
    return 2 * seed + ROLES.index(role)


@dataclasses.dataclass
class Answer:
    index: int
    due: float
    done: float = 0.0
    ok: bool = False
    mode: str = ""
    degraded: str = ""
    error: str = ""


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""
    cell: dict
    config: dict
    traffic: dict
    window: tuple                      # (t0, t1) on the host clock
    answers: List[Answer]
    spans: Dict[str, List[tuple]]
    ttft: Dict[str, List[tuple]]       # role -> [(first token time, s)]
    trace: Optional[tracing.Trace]
    setup_s: float

    def spec(self, role: str) -> dict:
        return self.config["models"][role]["model"]

    def in_window(self) -> List[Answer]:
        """Answers that returned in the window."""
        t0, t1 = self.window
        return [a for a in self.answers if a.done and t0 <= a.done <= t1]

    def measured(self) -> List[Answer]:
        """The answers the end-to-end metrics are taken over: those that
        returned in the window (closed loop), or were due in it (open
        loop, waited for after the close)."""
        t0, t1 = self.window
        if self.traffic["loop"] == "open":
            return [a for a in self.answers if t0 <= a.due <= t1]
        return self.in_window()


class Recorder:
    """Spans around the calls into each layer, and what the judged calls
    returned. Installed on the pipeline's own objects by instance
    attributes: the program is not changed."""

    def __init__(self):
        self.spans: Dict[str, List[tuple]] = defaultdict(list)
        self.ttft: Dict[str, List[tuple]] = defaultdict(list)
        self.handles: List[tuple] = []
        self.calls_of: Dict[int, List[dict]] = defaultdict(list)
        self.tracing = False
        self.calls: List[tuple] = []   # traced model calls
        self.pages: Dict[str, int] = defaultdict(int)  # peak pages in use

    def span(self, name: str, t0: float, t1: float) -> None:
        self.spans[name].append((t0, t1))

    def install(self, pipe) -> None:
        fe_cloud = pipe.cloud
        self._wrap_engine(fe_cloud.engine, "cloud")
        for fe in pipe.edges.values():
            self._wrap_engine(fe.engine, "edge")
            self._wrap_fanout(fe)
        self._wrap_generate(fe_cloud, "cloud")

    def _pages(self, engine, role: str) -> None:
        self.pages[role] = max(self.pages[role], engine.alloc.pages_in_use)

    def _wrap_engine(self, engine, role: str) -> None:
        step, prefix = engine.step, engine.prefill_prefix
        chunk = engine.prefill_chunk

        def wrapped_step():
            before = None
            if self.tracing:
                before = {i: (s.ctx_len, len(s.prefill_toks))
                          for i, s in enumerate(engine.slots) if s.active}
            t0 = time.perf_counter()
            with tracing.annotate(self.tracing, f"{role}.step"):
                out = step()
            t1 = time.perf_counter()
            self.span(f"{role}.step", t0, t1)
            self._pages(engine, role)
            if before is not None:
                dec, ing = [], []
                for i, (ctx, pending) in before.items():
                    grown = engine.slots[i].ctx_len - ctx
                    if pending and grown > 0:
                        ing.append((ctx, grown))
                    elif not pending and grown == 1:
                        dec.append((ctx, 1))
                if dec:
                    self.calls.append((role, "decode", dec))
                if ing:
                    self.calls.append((role, "ingest", ing))
            return out

        def wrapped_prefix(toks):
            t0 = time.perf_counter()
            with tracing.annotate(self.tracing, f"{role}.prefix"):
                slot = prefix(toks)
            self.span(f"{role}.prefix", t0, time.perf_counter())
            self._pages(engine, role)
            if self.tracing:
                n = len(toks)
                size = chunk or max(n, 1)
                self.calls.append((role, "prefix", [
                    (o, min(size, n - o)) for o in range(0, n, size)]))
            return slot

        engine.step = wrapped_step
        engine.prefill_prefix = wrapped_prefix

    def _wrap_generate(self, fe, role: str) -> None:
        gen, submit = fe.generate_async, fe.submit

        def wrapped_submit(req, sheddable=True):
            h = submit(req, sheddable)
            self.handles.append((role, h))
            return h

        async def wrapped_generate(prompts, **kw):
            t0 = time.perf_counter()
            outs = await gen(prompts, **kw)
            self.span(f"{role}.call", t0, time.perf_counter())
            rid = _request.get()
            if rid is not None:
                for p, (toks, lps) in zip(prompts, outs):
                    self.calls_of[rid].append(
                        {"role": role, "prompt": list(p), "served": toks,
                         "lps": lps})
            return outs

        fe.submit = wrapped_submit
        fe.generate_async = wrapped_generate

    def _wrap_fanout(self, fe) -> None:
        fan = fe.generate_fanout_async

        async def wrapped_fanout(prefix, suffixes, **kw):
            t0 = time.perf_counter()
            outs = await fan(prefix, suffixes, **kw)
            self.span("edge.expand", t0, time.perf_counter())
            rid = _request.get()
            if rid is not None:
                for sfx, (toks, lps) in zip(suffixes, outs):
                    self.calls_of[rid].append(
                        {"role": "edge", "prompt": list(prefix) + list(sfx),
                         "served": toks, "lps": lps})
            return outs

        fe.generate_fanout_async = wrapped_fanout

    def settle_ttft(self) -> None:
        for role, h in self.handles:
            if h.first_token_s is not None and h.ttft_s is not None:
                self.ttft[role].append((h.first_token_s, h.ttft_s))
        self.handles.clear()


# ---------------------------------------------------------------------------
# The fleet
# ---------------------------------------------------------------------------

def max_context(role: str, traffic: dict, max_len: int) -> int:
    """The longest context the mix gives an engine of `role`: the cloud
    reads its prompt template, the query and at most the sketch or the
    answer; an edge the (query, sketch) prefix, the query again as the
    suffix, and the expansion."""
    q = traffic["query_tokens"][1]
    new = traffic["max_new_tokens"][1]
    if role == "cloud":
        n = q + 16 + max(new, 170)
    else:
        n = 2 * q + 16 + 170 + new
    return min(n, max_len)


class Fleet:
    """The cloud and edge engines of a configuration, and the pipeline
    over them, built as the configuration states."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.configs.registry import get_config
        from repro_torch.core.profiler import LatencyModel
        from repro_torch.core.progressive import PICEConfig, PICEPipeline
        from repro_torch.core.scheduler import EdgeModelInfo
        from repro_torch.models import transformer
        from repro_torch.serving.engine import InferenceEngine
        from repro_torch.serving.network import NetworkModel

        self.engines = {}
        for role in ROLES:
            m = config["models"][role]
            cfg = get_config(m["registry"]).with_(**m["model"])
            params = transformer.init_params(cfg, seed=role_seed(seed, role),
                                             device=device)
            e = m["engine"]
            self.engines[role] = InferenceEngine(
                cfg, params, max_batch=e["max_batch"], max_len=e["max_len"],
                kv_backend="paged", page_size=e["page_size"],
                n_pages=e["n_pages"], name=m["name"], device=device)
        for role in traffic["warm"]:
            eng = self.engines[role]
            eng.warmup(max_context=max_context(role, traffic, eng.max_len))

        def latency(m):
            return LatencyModel(t0=m["latency"]["t0"],
                                rate=m["latency"]["rate"], name=m["name"])

        cm, em = config["models"]["cloud"], config["models"]["edge"]
        self.pipe = PICEPipeline(
            self.engines["cloud"], {em["name"]: self.engines["edge"]},
            latency(cm), [EdgeModelInfo(em["name"], latency(em),
                                        em["capability"])],
            network=NetworkModel(), cfg=PICEConfig())

    def truncated(self) -> int:
        return sum(len(e.truncations) for e in self.engines.values())


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def build_clock(out: dict):
    """Time the program's kernel builds (`runtime.build_all`, which the
    engines' warm-up calls) into `out["build_s"]`: nvcc's share of set-up,
    which only a checkout's first run pays."""
    from repro_torch.kernels import runtime
    build = runtime.build_all
    out["build_s"] = 0.0

    def timed(*args, **kw):
        t = time.perf_counter()
        try:
            return build(*args, **kw)
        finally:
            out["build_s"] += time.perf_counter() - t

    runtime.build_all = timed
    try:
        yield out
    finally:
        runtime.build_all = build


def cell_limits(name: str) -> dict:
    """`limits/<cell>.json`: the limit of each number compared in the cell
    (none before the cell's limits are set)."""
    path = HERE / "limits" / f"{name}.json"
    return load_json(path)["limits"] if path.exists() else {}


class Run:
    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device, t_start: float,
                 limits: Optional[dict] = None, control: bool = False):
        """`limits` default to the cell's file; `control` also reads the
        reference's float8 computation (calibration only)."""
        self.cell, self.config, self.traffic = cell, config, traffic
        self.control = control
        self.limits = cell_limits(cell["name"]) if limits is None \
            else limits
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.rec = Recorder()
        self.answers: List[Answer] = []
        self.window = (0.0, 0.0)
        self.setup_s = 0.0
        self.late: List[float] = []
        self.trace_data: Optional[tracing.Trace] = None
        self.trace_start_s = 0.0

    async def _send(self, item: generator.Item, due: float) -> None:
        from repro_torch.serving.requests import Request
        a = Answer(item.index, due)
        self.answers.append(a)
        _request.set(item.index)
        try:
            resp = await self.fleet.pipe.handle_async(Request(
                query=item.query, category=item.category,
                max_new_tokens=item.max_new_tokens, arrival_time_s=due))
        except Exception as exc:   # a failed answer is a data point
            a.done, a.error = time.perf_counter(), repr(exc)
            return
        a.done = time.perf_counter()
        a.ok = not resp.degraded
        a.mode, a.degraded = resp.mode, resp.degraded

    async def _drive(self) -> None:
        p = self.traffic
        if self.trace:
            tracing.warm(self.device)
        drv = generator.driver(p, self.seed)
        drv.start(self._send)
        if p["loop"] == "closed":
            while sum(1 for a in self.answers if a.done) < p["ramp_answers"]:
                await asyncio.sleep(0.005)
        else:
            await asyncio.sleep(p["ramp_s"])
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_start
        prof = None
        end = t0 + self.seconds
        if self.trace:
            span = min(TRACE_S, self.seconds / 4)
            await asyncio.sleep(max(end - span - time.perf_counter(), 0.0))
            t = time.perf_counter()
            prof = tracing.start(self.device)
            self.trace_start_s = time.perf_counter() - t
            self.rec.tracing = True
            # a profiler slow to start lengthens the traced run's window,
            # whose end-to-end metrics are not reported
            end = max(end, time.perf_counter() + span)
        await asyncio.sleep(max(end - time.perf_counter(), 0.0))
        t1 = time.perf_counter()
        self.window = (t0, t1)
        if prof is not None:
            # reducing the trace holds the event loop for seconds: a traced
            # run, whose end-to-end metrics are not reported, offers nothing
            # after its window
            drv.stop()
            self.rec.tracing = False
            self.trace_data = tracing.stop(prof, self.rec.calls)
        if p["loop"] == "open":
            # wait for what was due in the window, offering load meanwhile
            limit = t1 + p["drain_s"]
            while (time.perf_counter() < limit and
                   any(not a.done for a in self.answers if a.due <= t1)):
                await asyncio.sleep(0.005)
        drv.stop()
        self.late = [late for due, late in zip(drv.dues, drv.late)
                     if t0 <= due <= t1]
        # asyncio.run cancels the requests still in flight on return

    def measure(self, fleet: Fleet, install: bool = True) -> "Context":
        """Offer the mix to `fleet` for the window; the context the
        metrics are read from. `install=False` leaves the spans of an
        earlier run's recorder on the fleet (a sweep over one fleet)."""
        self.fleet = fleet
        if install:
            self.rec.install(fleet.pipe)
        asyncio.run(self._drive())
        self.rec.settle_ttft()
        return Context(self.cell, self.config, self.traffic, self.window,
                       self.answers, dict(self.rec.spans),
                       dict(self.rec.ttft), self.trace_data, self.setup_s)

    def execute(self) -> dict:
        torch.set_num_threads(4)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        build = {}
        with build_clock(build):
            ctx = self.measure(Fleet(self.config, self.traffic, self.seed,
                                     self.device))
        pools = {role: [self.rec.pages[role], e.n_pages]
                 for role, e in self.fleet.engines.items()}
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        names = metric_names(self.cell, "per_layer" if self.trace
                             else "end_to_end")
        metrics = {}
        for name, unit in names:
            v = read_metric(name, ctx)
            if v is not None and math.isfinite(v):
                metrics[name] = {"value": v, "unit": unit}
        measured = ctx.measured()
        attempted = len(measured)
        failed = sum(1 for a in measured if not a.ok)
        truncated = self.fleet.truncated()
        sample = self.sample(measured)
        del ctx, measured
        self.release()
        checks = judge(self.config, self.limits, self.seed, sample,
                       self.device, control=self.control)
        verdict = compared(checks)
        correct = is_correct(verdict, failed, truncated)
        device = describe_device(self.device, peak)
        if self.trace_data is not None:
            device["busy_s"] = self.trace_data.busy_s
            device["window_s"] = self.trace_data.window_s
        out = {"correct": correct,
               "attempted": attempted,
               "failed": failed, "metrics": metrics, "device": device}
        if self.trace_data is not None:
            out["breakdown"] = self.trace_data.breakdown()
        out["checks"] = verdict
        self.readings = checks
        if self.control:
            self.control_correct = is_correct(control_compared(checks), 0, 0)
        self.notes = {"truncated": truncated, "sampled": len(sample),
                      "late_max_s": max(self.late, default=0.0),
                      "build_s": build["build_s"],
                      "trace_start_s": self.trace_start_s,
                      "pages_peak_of": pools,
                      "answers": len(self.answers),
                      "errors": sorted({a.error for a in self.answers
                                        if a.error})[:3]}
        return out

    def sample(self, measured: List[Answer]) -> List[dict]:
        """The judged calls: of the measured answers that returned whole,
        the one with the most served tokens and others drawn from the
        seed, `sample` in all."""
        calls = self.rec.calls_of
        whole = [a for a in measured if a.ok and calls.get(a.index)]
        if not whole:
            return []
        size = {a.index: sum(len(c["served"]) for c in calls[a.index])
                for a in whole}
        longest = max(whole, key=lambda a: (size[a.index], -a.index))
        rest = sorted((a for a in whole if a is not longest),
                      key=lambda a: a.index)
        k = min(self.traffic["sample"], len(whole)) - 1
        picked = [longest] + random.Random(f"sample/{self.seed}").sample(
            rest, k)
        return [c for a in picked for c in calls[a.index]]

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.fleet = None
        self.rec = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def describe_device(device: torch.device, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


# ---------------------------------------------------------------------------
# Metrics, by name
# ---------------------------------------------------------------------------

def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def metric_names(cell: dict, kind: str) -> List[tuple]:
    """(name, unit) of the `kind` metrics the cell reports: those that list
    it under "workloads", or list no cells."""
    out = []
    for m in benchmark()[kind]:
        cells = m.get("workloads")
        if cells is None or cell["name"] in cells:
            out.append((m["name"], m["unit"]))
    return out


def reader_path(name: str) -> Path:
    """The reader of metric `name`: `metrics/<name>.py`, or else that of the
    name without its last dotted part, and so on (`mfu.rag` and
    `mfu.closed` share `metrics/mfu.py`, each listing its own cells)."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        path = HERE / "metrics" / (".".join(parts[:k]) + ".py")
        if path.exists():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} in metrics/")


def read_metric(name: str, ctx: Context):
    """Run the metric's reader's `read(ctx)` (`reader_path`): a number, or
    None where it finds nothing to read."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "pice_bench_metric_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    v = mod.read(ctx)
    return None if v is None else float(v)


# ---------------------------------------------------------------------------
# Correctness
# ---------------------------------------------------------------------------

def judge(config: dict, limits: dict, seed: int, sample: List[dict],
          device, control: bool = False) -> Dict[str, dict]:
    """Run each role's plain reference over its judged calls and read, per
    role, the widest gap (`<role>.gap`), the widest logprob difference
    (`<role>.lp`) and the mean logprob difference (`<role>.lp_mean`) of a
    served token. The numbers that `limits` gives a
    limit are the ones compared; the others are read for the
    record (`limit` None). With `control` the reference's float8
    computation is read too (`<name>.control`; never part of a verdict)."""
    checks: Dict[str, dict] = {}
    for role in ROLES:
        seqs = []
        for c in sample:
            if c["role"] != role or not c["served"]:
                continue
            toks = c["prompt"] + c["served"][:-1]
            first = len(c["prompt"]) - 1
            seqs.append({"tokens": toks,
                         "rows": list(range(first, first + len(c["served"]))),
                         "served": c["served"], "lps": c["lps"]})
        if not seqs:
            continue
        spec = config["models"][role]["model"]
        ref = importlib.import_module(
            f"pice_bench.reference.{spec['family']}")
        res = ref.run(spec, role_seed(seed, role), seqs, device,
                      control=control)
        n = sum(r["n"] for r in res)
        for key in ("gap", "lp", "lp_mean"):
            name = f"{role}.{key}"

            def value(prefix):
                if key == "lp_mean":
                    return sum(r[prefix + "lp_sum"] for r in res) / n
                return max(r[prefix + key] for r in res)

            checks[name] = {"value": value(""), "limit": limits.get(name)}
            if control:
                checks[f"{name}.control"] = {"value": value("control_"),
                                             "limit": limits.get(name)}
    return checks


def compared(checks: Dict[str, dict]) -> Dict[str, dict]:
    """The numbers a run's verdict rests on: those with a limit."""
    return {k: v for k, v in checks.items()
            if v["limit"] is not None and not k.endswith(".control")}


def control_compared(checks: Dict[str, dict]) -> Dict[str, dict]:
    """The control's readings of the numbers a verdict rests on, under the
    program's names and limits."""
    return {k[:-len(".control")]: v for k, v in checks.items()
            if k.endswith(".control") and v["limit"] is not None}


def is_correct(verdict: Dict[str, dict], failed: int, truncated: int
               ) -> bool:
    """A run is correct when it judged something, no measured answer
    failed, nothing was truncated, and every compared number is within its
    limit."""
    return bool(verdict) and failed == 0 and truncated == 0 and all(
        c["value"] <= c["limit"] for c in verdict.values())
