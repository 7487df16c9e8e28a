"""Event-driven cloud-edge serving simulator (calibrated mode).

Reproduces the paper's testbed benchmarks (Table III, Figs 3/6/12/13/14)
with latency models calibrated to the paper's own hardware numbers
(profiler.PAPER_CLOUD_SPEEDS / Table II bandwidth ratio). Four methods:

  cloud_only   — all queries served by the cloud LLM (vLLM-style slots)
  edge_only    — load-balanced across edge SLM devices
  routing      — difficulty router sends easy queries to edge, rest to cloud
  pice         — progressive inference (dynamic or static scheduling)

The simulator models: cloud batch slots (continuous batching), per-request
decode time f(l), network Delta(r), the multi-list job queue, edge devices
pulling uniform-length batches, execution-optimizer parallelism, and
Algorithm-2 model up/downgrades.
"""
from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Dict, List, Optional

from repro_torch.core.dispatch import MultiListQueue
from repro_torch.core.exec_optimizer import plan_expansion
from repro_torch.core.profiler import RuntimeMonitor, capability, paper_latency_model
from repro_torch.core.scheduler import DynamicScheduler, EdgeModelInfo
from repro_torch.serving.network import NetworkModel
from repro_torch.serving.requests import SketchTask


@dataclasses.dataclass
class SimRequest:
    req_id: int
    arrival_s: float
    answer_len: int               # true response length l_i
    sketch_ratio: float = 0.3     # gold sketch compression
    category: str = "generic"
    difficulty: float = 0.5       # for the routing baseline
    # filled during sim:
    done_s: float = -1.0
    mode: str = ""


@dataclasses.dataclass
class SimResult:
    throughput_per_min: float
    avg_latency_s: float
    p95_latency_s: float
    completed: int
    offered: int
    cloud_tokens: int
    edge_tokens: int
    mode_counts: Dict[str, int]

    def row(self) -> dict:
        return dataclasses.asdict(self)


def make_requests(n: int, rpm: float, seed: int = 0, mean_len: int = 500,
                  short_frac: float = 0.2) -> List[SimRequest]:
    rng = random.Random(seed)
    out = []
    t = 0.0
    for i in range(n):
        t += rng.expovariate(rpm / 60.0)
        if rng.random() < short_frac:
            l = max(10, int(rng.gauss(40, 15)))         # short answers
        else:
            l = max(60, int(rng.gauss(mean_len, mean_len * 0.3)))
        out.append(SimRequest(req_id=i, arrival_s=t, answer_len=l,
                              difficulty=rng.random()))
    return out


class _Server:
    """A batch-slot server (cloud LLM under continuous batching, or one edge
    device). Work items occupy a slot for `duration`; queue when full.

    `contention` models memory-bandwidth sharing across a full batch: the
    per-request decode rate degrades as slots fill (vLLM per-request tok/s at
    max batch is well below the solo speed; this derating calibrates
    cloud-only saturation to the paper's Table III latencies)."""

    def __init__(self, slots: int, contention: float = 1.6):
        self.slots = slots
        self.contention = contention
        self.free_at = [0.0] * slots

    def submit(self, now: float, duration: float) -> float:
        """Returns completion time; occupies the earliest-free slot."""
        i = min(range(self.slots), key=lambda j: self.free_at[j])
        busy = sum(1 for t in self.free_at if t > now)
        duration *= 1.0 + self.contention * busy / max(self.slots, 1)
        start = max(now, self.free_at[i])
        end = start + duration
        self.free_at[i] = end
        return end


def ScheduleDecisionStatic(sketch_tokens: int, edge_model: str):
    from repro_torch.core.scheduler import ScheduleDecision
    return ScheduleDecision(mode="progressive", sketch_tokens=sketch_tokens,
                            edge_model=edge_model, parallelism=2)


@dataclasses.dataclass
class SimConfig:
    cloud_model: str = "llama3-70b"
    edge_models: tuple = ("llama3-8b", "qwen2.5-7b", "qwen2.5-1.5b")
    n_edge_devices: int = 4
    cloud_batch: int = 20
    edge_batch: int = 4
    rpm: float = 30.0
    n_requests: int = 200
    bandwidth_mbps: float = 100.0
    queue_max: int = 8
    dynamic: bool = True           # dynamic vs static PICE scheduling
    static_sketch_ratio: float = 0.4
    max_parallelism: int = 8
    seed: int = 0


def _edge_infos(cfg: SimConfig) -> List[EdgeModelInfo]:
    return [EdgeModelInfo(name=m, latency=paper_latency_model(m, "edge"),
                          capability=capability(m))
            for m in cfg.edge_models]


def _finalize(reqs: List[SimRequest], cloud_toks: int, edge_toks: int
              ) -> SimResult:
    done = [r for r in reqs if r.done_s >= 0]
    lat = sorted(r.done_s - r.arrival_s for r in done)
    horizon = max((r.done_s for r in done), default=1.0)
    modes: Dict[str, int] = {}
    for r in done:
        modes[r.mode] = modes.get(r.mode, 0) + 1
    return SimResult(
        throughput_per_min=60.0 * len(done) / max(horizon, 1e-9),
        avg_latency_s=sum(lat) / max(len(lat), 1),
        p95_latency_s=lat[int(0.95 * (len(lat) - 1))] if lat else 0.0,
        completed=len(done), offered=len(reqs),
        cloud_tokens=cloud_toks, edge_tokens=edge_toks, mode_counts=modes)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

def simulate_cloud_only(cfg: SimConfig, reqs: Optional[List[SimRequest]] = None
                        ) -> SimResult:
    reqs = reqs or make_requests(cfg.n_requests, cfg.rpm, cfg.seed)
    cloud = paper_latency_model(cfg.cloud_model, "cloud")
    server = _Server(cfg.cloud_batch)
    toks = 0
    for r in reqs:
        r.done_s = server.submit(r.arrival_s, cloud.f(r.answer_len))
        r.mode = "cloud_full"
        toks += r.answer_len
    return _finalize(reqs, toks, 0)


def simulate_edge_only(cfg: SimConfig, reqs: Optional[List[SimRequest]] = None
                       ) -> SimResult:
    reqs = reqs or make_requests(cfg.n_requests, cfg.rpm, cfg.seed)
    infos = _edge_infos(cfg)
    # each edge device hosts one SLM, queries dispatched load-balanced
    devices = [(_Server(cfg.edge_batch),
                infos[i % len(infos)]) for i in range(cfg.n_edge_devices)]
    net = NetworkModel(bandwidth_mbps=cfg.bandwidth_mbps)
    toks = 0
    for i, r in enumerate(reqs):
        server, info = devices[i % len(devices)]
        d = net.delay_s(64) + info.latency.f(r.answer_len)
        r.done_s = server.submit(r.arrival_s, d)
        r.mode = "edge_only"
        toks += r.answer_len
    return _finalize(reqs, 0, toks)


def simulate_routing(cfg: SimConfig, reqs: Optional[List[SimRequest]] = None,
                     easy_threshold: float = 0.45) -> SimResult:
    """Hybrid-LLM-style difficulty router [8]."""
    reqs = reqs or make_requests(cfg.n_requests, cfg.rpm, cfg.seed)
    cloud = paper_latency_model(cfg.cloud_model, "cloud")
    infos = _edge_infos(cfg)
    cloud_srv = _Server(cfg.cloud_batch)
    edges = [(_Server(cfg.edge_batch), infos[i % len(infos)])
             for i in range(cfg.n_edge_devices)]
    net = NetworkModel(bandwidth_mbps=cfg.bandwidth_mbps)
    ct = et = 0
    k = 0
    for r in reqs:
        if r.difficulty < easy_threshold:
            srv, info = edges[k % len(edges)]
            k += 1
            r.done_s = srv.submit(r.arrival_s,
                                  net.delay_s(64) + info.latency.f(r.answer_len))
            r.mode = "edge"
            et += r.answer_len
        else:
            r.done_s = cloud_srv.submit(r.arrival_s, cloud.f(r.answer_len))
            r.mode = "cloud"
            ct += r.answer_len
    return _finalize(reqs, ct, et)


# ---------------------------------------------------------------------------
# PICE
# ---------------------------------------------------------------------------

def simulate_pice(cfg: SimConfig, reqs: Optional[List[SimRequest]] = None
                  ) -> SimResult:
    reqs = reqs or make_requests(cfg.n_requests, cfg.rpm, cfg.seed)
    cloud = paper_latency_model(cfg.cloud_model, "cloud")
    infos = sorted(_edge_infos(cfg), key=lambda e: e.capability)
    net = NetworkModel(bandwidth_mbps=cfg.bandwidth_mbps)
    monitor = RuntimeMonitor()
    sched = DynamicScheduler(cloud, infos, net, cfg.n_edge_devices,
                             monitor=monitor, queue_max=cfg.queue_max)
    cloud_srv = _Server(cfg.cloud_batch)
    edge_srvs = [_Server(1) for _ in range(cfg.n_edge_devices)]
    queue = MultiListQueue(max_size=cfg.queue_max)
    ct = et = 0
    short_cut = 48

    # event loop: requests arrive -> cloud phase done -> edge phase done
    events: list = []   # (time, seq, kind, payload)
    seq = 0
    for r in reqs:
        heapq.heappush(events, (r.arrival_s, seq, "arrive", r)); seq += 1
    edge_free = [0.0] * cfg.n_edge_devices
    edge_cur_model = [infos[-1 if cfg.dynamic else 0].name] * cfg.n_edge_devices

    def dispatch_edge(now: float):
        nonlocal seq, et
        for d in range(cfg.n_edge_devices):
            if edge_free[d] > now or not len(queue):
                continue
            batch = queue.pull_batch(cfg.edge_batch)
            if not batch:
                continue
            for t in batch:
                monitor.on_dequeue(t.expected_length)
            if cfg.dynamic:
                # Algorithm 2: model up/downgrade for this batch
                from repro_torch.core.selection import select_model
                lead = max(batch, key=lambda t: t.expected_length)
                sel = select_model(edge_cur_model[d], infos,
                                   lead.expected_length, lead.sketch_tokens,
                                   cloud, len(queue), cfg.queue_max)
                edge_cur_model[d] = sel.model
            info = next(e for e in infos if e.name == edge_cur_model[d])
            # execution optimizer: parallel groups per task; Eq.(2) budget
            # nets out the sketch-generation time already spent on the cloud
            dur = 0.0
            for t in batch:
                budget = (cloud.f(t.expected_length) - cloud.f(t.sketch_tokens)
                          if cfg.dynamic else 1e18)
                plan = plan_expansion(
                    t.sentences,
                    lambda p, lt: info.latency.f(lt),
                    latency_budget_s=budget,
                    max_parallelism=(cfg.max_parallelism if cfg.dynamic else 2))
                dur = max(dur, plan.est_latency_s)
                et_inc = t.expected_length
                heapq.heappush(events, (now + dur, seq, "edge_done",
                                        (t, d, et_inc))); seq += 1
            edge_free[d] = now + dur

    while events:
        now, _, kind, payload = heapq.heappop(events)
        if kind == "arrive":
            r: SimRequest = payload
            l = r.answer_len
            if cfg.dynamic:
                decision = sched.schedule(l)
            else:
                # static scheduling (paper Fig. 6 baseline): predefined rules
                # on predicted length only — fixed sketch ratio, fixed edge
                # model, no Eq.(2) feasibility / runtime adaptation.
                sk = int(cfg.static_sketch_ratio * l)
                decision = ScheduleDecisionStatic(sk, infos[0].name)
            if l <= short_cut or decision.mode == "cloud_full" or queue.full:
                done = cloud_srv.submit(now, cloud.f(l))
                r.done_s, r.mode = done, "cloud_full"
                ct += l
            else:
                sk = decision.sketch_tokens
                ct += sk
                cloud_done = cloud_srv.submit(now, cloud.f(sk))
                heapq.heappush(events, (cloud_done + net.delay_s(sk), seq,
                                        "sketch_ready", (r, sk))); seq += 1
        elif kind == "sketch_ready":
            r, sk = payload
            n_sent = max(1, sk // 12)        # ~12 tokens per sketch sentence
            sentences = [f"s{j} key tokens here" for j in range(n_sent)]
            task = SketchTask(req_id=r.req_id, query="", sketch="",
                              sentences=sentences, expected_length=r.answer_len,
                              sketch_tokens=sk, created_s=now)
            queue.push(task)
            monitor.on_enqueue(r.answer_len)
            r.mode = "progressive"
            r._task = task                    # type: ignore[attr-defined]
            dispatch_edge(now)
        elif kind == "edge_done":
            t, d, toks = payload
            et += toks
            for r in reqs:
                if r.req_id == t.req_id:
                    r.done_s = now
                    break
            dispatch_edge(now)
    return _finalize(reqs, ct, et)


METHODS = {
    "cloud_only": simulate_cloud_only,
    "edge_only": simulate_edge_only,
    "routing": simulate_routing,
    "pice": simulate_pice,
}
