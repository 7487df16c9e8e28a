"""The PICE progressive-inference orchestrator (paper Fig. 4 workflow).

Real-compute mode: drives actual InferenceEngine instances (cloud LLM + edge
SLM fleet) through the full pipeline —
  (1) cloud assesses expected response length l_i,
  (2a) short answer -> full cloud response, or
  (2b) cloud emits a sketch at the scheduler-chosen level,
  (3) the dispatcher queues the expansion task; the execution optimizer plans
      the parallel sentence groups (binary-tree merge),
  (4) edge SLMs expand groups IN PARALLEL; the ensemble picks the most
      confident expansion per group,
  (5) the stitched response returns to the user.

Engines are MULTIPLEXED: the pipeline wraps the cloud engine and each edge
engine in an `EngineFrontend` (serving/frontend.py) and submits every role —
sketch, full cloud answers, per-member expansion fan-outs — as prioritized,
cancellable requests through the request-handle API instead of owning the
engines. Ensemble members expand concurrently (`handle_async` gathers
them on one event loop), and many in-flight `handle_async` calls share one
engine fleet — the serving front-end's load path. `handle` is the
synchronous single-request facade over it.

While `repro_torch.trace` records, each answer is a `pipeline.answer`
span carrying its `req_id` (`mode`, `degraded`), over the awaits
`pipeline.sketch`, `pipeline.cloud_full` and `pipeline.expand` and the
host sections `pipeline.route` (length guess, schedule, prompt encoding),
`pipeline.plan` (segmenting, model selection, the expansion plan, the
prefix and suffix encodings) and `pipeline.ensemble`.
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Dict, List, Optional

from repro_torch import trace
from repro_torch.core import ensemble as ens
from repro_torch.core import exec_optimizer, sketch as sketch_lib
from repro_torch.core.dispatch import MultiListQueue
from repro_torch.core.profiler import LatencyModel, RuntimeMonitor
from repro_torch.core.scheduler import DynamicScheduler, EdgeModelInfo, ScheduleDecision
from repro_torch.core.selection import select_model
from repro_torch.data import tokenizer as tok
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.faults import EngineCrash
from repro_torch.serving.frontend import as_frontend
from repro_torch.serving.network import NetworkModel
from repro_torch.serving.requests import Request, Response, SketchTask


@dataclasses.dataclass
class PICEConfig:
    alpha1: float = 0.4            # Eq.(3) perplexity weight
    alpha2: float = 0.2            # Eq.(3) length weight
    max_sketch_tokens: int = 160
    short_answer_tokens: int = 48  # below this, always answer from cloud
    queue_max: int = 8
    max_parallelism: int = 8
    ensemble_size: int = 2         # how many edge models expand each group
    # sketch-transfer retry policy (NetworkModel.transfer_with_retry)
    transfer_max_attempts: int = 4
    transfer_backoff_s: float = 0.05


class PICEPipeline:
    def __init__(self, cloud_engine: InferenceEngine,
                 edge_engines: Dict[str, InferenceEngine],
                 cloud_latency: LatencyModel,
                 edge_infos: List[EdgeModelInfo],
                 network: Optional[NetworkModel] = None,
                 cfg: Optional[PICEConfig] = None,
                 n_edge_devices: Optional[int] = None):
        # default-construct per pipeline: a dataclass default instance in
        # the signature was SHARED across every pipeline, so one caller
        # mutating cfg.ensemble_size reconfigured all of them
        self.cfg = cfg = cfg or PICEConfig()
        self.network = network or NetworkModel()
        self.monitor = RuntimeMonitor()
        # every engine is served through a multiplexed front-end: raw
        # engines get wrapped here, pre-shared EngineFrontends pass through
        # (several pipelines — or the pipeline plus a load generator — can
        # then contend for the same slots/pages/priorities)
        self.cloud = as_frontend(cloud_engine, self.monitor)
        self.edges = {k: as_frontend(v, self.monitor)
                      for k, v in edge_engines.items()}
        self.queue = MultiListQueue(max_size=cfg.queue_max,
                                    monitor=self.monitor)
        self.edge_infos = sorted(edge_infos, key=lambda e: e.capability)
        self.scheduler = DynamicScheduler(
            cloud_latency, self.edge_infos, self.network,
            n_edge_devices or len(edge_engines), monitor=self.monitor,
            queue_max=cfg.queue_max)
        self.stats = {"progressive": 0, "cloud_full": 0}

    # ------------------------------------------------------------------
    def predict_length(self, req: Request) -> int:
        return sketch_lib.heuristic_expected_length(req.query, req.category)

    async def _cloud_generate(self, toks: List[int], max_new: int,
                              deadline_s: Optional[float] = None,
                              role: str = "cloud_full"):
        with trace.span("pipeline.sketch" if role == "sketch"
                        else "pipeline.cloud_full", awaits=True):
            (out, lps), = await self.cloud.generate_async(
                [toks], max_new=max_new, deadline_s=deadline_s, role=role)
        return tok.decode(out), out, lps

    def _edge_info_for(self, primary: str) -> EdgeModelInfo:
        """The EdgeModelInfo for `primary`, guarding against a model name
        the selector produced that no longer has a profile (a bare
        StopIteration otherwise): fall back to the most capable edge info
        and record the mismatch."""
        info = next((e for e in self.edge_infos if e.name == primary), None)
        if info is None:
            info = self.edge_infos[-1]      # sorted ascending by capability
            self.monitor.fallback_primaries += 1
        return info

    def _finish(self, resp: Response,
                queue_wait_s: float = 0.0) -> Response:
        self.stats[resp.mode] = self.stats.get(resp.mode, 0) + 1
        if resp.degraded:
            self.monitor.record_degraded(resp.degraded)
        resp.queue_wait_s = queue_wait_s
        return resp

    # ------------------------------------------------------------------
    async def _degrade_cloud(self, req: Request, l_i: int, t_start: float,
                             budget_s: float, deadline: Optional[float],
                             sketch_text: str, n_sketch_toks: int,
                             faults: Dict[str, int], retries: int,
                             net_delay: float = 0.0,
                             queue_wait_s: float = 0.0) -> Response:
        """Degradation rungs when the edge path is unavailable (all members
        faulted, the sketch transfer was lost, or the dispatch queue shed
        the task): re-answer from the cloud while budget remains, else hand
        back the sketch itself — every request gets SOME answer."""
        now = time.perf_counter()
        if deadline is None or now < deadline:
            text, out, _ = await self._cloud_generate(
                tok.encode(sketch_lib.cloud_full_prompt(req.query)),
                max_new=l_i, deadline_s=deadline, role="cloud_full")
            return self._finish(Response(
                req_id=req.req_id, text=text.strip(), mode="cloud_full",
                cloud_tokens=n_sketch_toks + len(out),
                latency_s=time.perf_counter() - t_start + net_delay,
                network_s=net_delay, model_used=self.cloud.name,
                degraded="cloud_full_fallback", retries=retries,
                deadline_s=budget_s, faults=faults), queue_wait_s)
        return self._finish(Response(
            req_id=req.req_id, text=(sketch_text or req.query).strip(),
            mode="progressive", cloud_tokens=n_sketch_toks,
            latency_s=now - t_start + net_delay, network_s=net_delay,
            model_used=self.cloud.name, degraded="sketch_passthrough",
            retries=retries, deadline_s=budget_s, faults=faults),
            queue_wait_s)

    def handle(self, req: Request) -> Response:
        """Synchronous single-request facade over `handle_async`: runs one
        fresh event loop to completion. Callers already inside a loop (the
        serving front-end, concurrent pipelines) use `handle_async`."""
        return asyncio.run(self.handle_async(req))

    async def handle_async(self, req: Request) -> Response:
        """Answer one request; the `pipeline.answer` span, carrying its
        `req_id`, is the root of every span made on its behalf."""
        with trace.span("pipeline.answer", awaits=True,
                        req_id=req.req_id) as sp:
            resp = await self._answer(req)
            if sp is not None:
                sp.attrs["mode"] = resp.mode
                sp.attrs["degraded"] = resp.degraded
        return resp

    async def _answer(self, req: Request) -> Response:
        now = time.perf_counter()
        # latency (and the SLA deadline) anchor at ARRIVAL when the request
        # carries a stamp — time queued upstream counts against the budget
        t_start = req.arrival_time_s if req.arrival_time_s is not None \
            else now
        queue_wait = now - t_start
        budget_s = req.sla.max_latency_s or 0.0
        deadline = (t_start + budget_s) if budget_s else None
        faults: Dict[str, int] = {}

        def fault(kind: str) -> None:
            faults[kind] = faults.get(kind, 0) + 1

        with trace.span("pipeline.route"):
            # refresh KV-memory telemetry so Eq.(2) sees real page-pool
            # pressure
            self.monitor.observe_engines(self.edges.values())
            l_i = min(self.predict_length(req), req.max_new_tokens)
            # short answers: no progressive inference (workflow step 2a)
            if l_i <= self.cfg.short_answer_tokens:
                decision = ScheduleDecision(mode="cloud_full")
            else:
                decision = self.scheduler.schedule(l_i, sla=req.sla)
            if decision.mode == "cloud_full":
                prompt = sketch_lib.cloud_full_prompt(req.query)
            else:
                prompt = sketch_lib.cloud_sketch_prompt(
                    req.query, decision.sketch_tokens)
            prompt_toks = tok.encode(prompt)

        if decision.mode == "cloud_full":
            text, out, _ = await self._cloud_generate(
                prompt_toks, max_new=l_i, deadline_s=deadline,
                role="cloud_full")
            return self._finish(Response(
                req_id=req.req_id, text=text.strip(),
                mode="cloud_full", cloud_tokens=len(out),
                latency_s=time.perf_counter() - t_start,
                model_used=self.cloud.name, deadline_s=budget_s,
                faults=faults), queue_wait)

        # ---- progressive path (2b..5) -----------------------------------
        sketch_text, sk_toks, _ = await self._cloud_generate(
            prompt_toks, max_new=min(decision.sketch_tokens + 10,
                                     self.cfg.max_sketch_tokens),
            deadline_s=deadline, role="sketch")
        with trace.span("pipeline.plan"):
            sketch_text = sketch_text.strip()
            sentences = sketch_lib.segment_sketch(sketch_text)
            if not sentences:
                sentences = [sketch_text or req.query]
            task = SketchTask(req_id=req.req_id, query=req.query,
                              sketch=sketch_text, sentences=sentences,
                              expected_length=l_i,
                              sketch_tokens=len(sk_toks))
            pushed = self.queue.push(task)
        if not pushed:
            # the dispatch queue is full and this task is the least critical
            # of the lot: shed it from the edge path, not from service
            fault("queue_shed")
            return await self._degrade_cloud(
                req, l_i, t_start, budget_s, deadline, sketch_text,
                len(sk_toks), faults, retries=0, queue_wait_s=queue_wait)
        self.monitor.on_enqueue(l_i)

        # ship the sketch to the edge over the faultable link (retry with
        # capped jittered exponential backoff; latency is modeled)
        xfer = self.network.transfer_with_retry(
            task.sketch_tokens * self.network.bytes_per_token,
            max_attempts=self.cfg.transfer_max_attempts,
            base_backoff_s=self.cfg.transfer_backoff_s)
        self.monitor.record_transfer(xfer.ok, xfer.attempts)
        retries = xfer.attempts - 1
        net_delay = xfer.latency_s
        if xfer.failure:
            fault("transfer_" + xfer.failure)
        if not xfer.ok:
            # the sketch never reached the edge fleet: unqueue and degrade
            self.queue.pull_batch(1)
            self.monitor.on_dequeue(l_i)
            return await self._degrade_cloud(
                req, l_i, t_start, budget_s, deadline, sketch_text,
                len(sk_toks), faults, retries, net_delay,
                queue_wait_s=queue_wait)

        with trace.span("pipeline.plan"):
            # Algorithm 2: (re)select the SLM against the remaining budget
            sel = select_model(decision.edge_model, self.edge_infos, l_i,
                               task.sketch_tokens, self.scheduler.cloud,
                               queue_len=len(self.queue),
                               queue_max=self.cfg.queue_max)
            einfo = self._edge_info_for(sel.model)
            primary = einfo.name

            # execution optimizer: binary-tree merge plan
            budget = self.scheduler.cloud.f(l_i) - self.scheduler.cloud.f(
                task.sketch_tokens)

            def lat(p, longest_tokens):
                return einfo.latency.f(longest_tokens)

            plan = exec_optimizer.plan_expansion(
                sentences, lat, budget,
                max_parallelism=self.cfg.max_parallelism)

            # pull the task (single-node real-compute: the queue round-trips)
            self.queue.pull_batch(1)
            self.monitor.on_dequeue(l_i)

            # expand groups on the ensemble of edge engines; under KV-memory
            # pressure fall back to the primary model alone — unless the fleet
            # is already absorbing the fan-out via COW prefix sharing (mostly-
            # shared occupancy means an extra member costs tail pages, not a
            # second prefix)
            names = self._ensemble_names(primary)
            if (self.monitor.kv_utilization > 0.85
                    and self.monitor.kv_shared_fraction <= 0.5):
                names = names[:1]
            per_tok = max(len(tok.encode(" ".join(g))) for g in plan.groups)
            max_new = min(int(per_tok * 3.5) + 24, req.max_new_tokens)
            # the exec-optimizer's parallel segments all repeat the same
            # (query, sketch) context: prefill it once per engine and fork the
            # per-group suffixes off it (paged backend; dense falls back to
            # independent submissions inside generate_fanout)
            prefix_toks = tok.encode(
                sketch_lib.edge_expand_prefix(req.query, sketch_text))
            suffix_toks = [tok.encode(sketch_lib.edge_expand_suffix(g))
                           for g in plan.groups]
        chosen: List[str] = []
        total_conf, edge_tokens = 0.0, 0
        hedges = 0

        async def run_member(name: str):
            """One ensemble member's expansion, submitted through its
            engine's multiplexed front-end. SLA intent rides with the work:
            the primary member's fan-out is latency-critical (priority 1),
            extra ensemble members opportunistic (0) — on a shared engine,
            eviction and admission order favor the critical work (see
            engine._evict_victim)."""
            eng = self.edges[name]
            prio = 1 if name == primary else 0
            role = "expansion_primary" if name == primary \
                else "expansion_extra"
            try:
                outs = await eng.generate_fanout_async(
                    prefix_toks, suffix_toks, max_new=max_new,
                    priority=prio, deadline_s=deadline, role=role)
            except (EngineCrash, MemoryError) as exc:
                # injected crash / pool exhaustion: drop this member, scrub
                # its engine state, and let quorum-1 pick from the rest
                eng.abort_all()
                self.monitor.record_edge_result(False)
                fault("edge_" + type(exc).__name__)
                return name, None
            self.monitor.record_edge_result(True)
            return name, outs

        launched = []
        for name in names:
            if deadline is not None and time.perf_counter() >= deadline:
                # budget exhausted: don't launch further members — ensemble
                # selects from whatever already returned (quorum 1)
                break
            if name != primary:
                hedges += 1
            launched.append(run_member(name))
        # members expand CONCURRENTLY (workflow step 4's parallel edge
        # expansion): each fan-out is its own stream of prioritized
        # requests on its engine's front-end, all driven by one event loop
        with trace.span("pipeline.expand", awaits=True):
            member_outs = await asyncio.gather(*launched) if launched else []
        group_results = {n: outs for n, outs in member_outs
                         if outs is not None}
        if not group_results:
            # every member faulted or the deadline arrived before any could
            # launch: the edge path produced nothing
            return await self._degrade_cloud(
                req, l_i, t_start, budget_s, deadline, sketch_text,
                len(sk_toks), faults, retries, net_delay,
                queue_wait_s=queue_wait)
        with trace.span("pipeline.ensemble"):
            degraded = "ensemble_partial" if len(group_results) < len(names) \
                else ""
            for gi in range(len(plan.groups)):
                cands = []
                for name, outs in group_results.items():
                    out, lps = outs[gi]
                    if not out:
                        # deadline-cancelled before its first token
                        continue
                    cands.append(ens.Candidate(
                        text=tok.decode(out).strip(),
                        mean_log2_prob=ens.mean_log2_from_nats(lps),
                        n_tokens=len(out), model=name))
                if not cands:
                    # no member produced this group: the sketch sentences
                    # themselves are the (terse but correct-topic) fallback
                    chosen.append(" ".join(plan.groups[gi]))
                    degraded = "sketch_groups"
                    continue
                best, scores = ens.select_best(
                    cands, sketch_text, self.cfg.alpha1, self.cfg.alpha2)
                chosen.append(best.text)
                total_conf += max(scores)
                edge_tokens += best.n_tokens
            text = " ".join(chosen).strip()
        return self._finish(Response(
            req_id=req.req_id, text=text, mode="progressive",
            cloud_tokens=len(sk_toks), edge_tokens=edge_tokens,
            latency_s=time.perf_counter() - t_start + net_delay,
            network_s=net_delay,
            confidence=total_conf / max(len(plan.groups), 1),
            model_used=primary, degraded=degraded, retries=retries,
            hedges=hedges, deadline_s=budget_s, faults=faults), queue_wait)

    def _ensemble_names(self, primary: str) -> List[str]:
        names = [primary]
        for e in reversed(self.edge_infos):         # most capable first
            if e.name != primary and e.name in self.edges:
                names.append(e.name)
            if len(names) >= self.cfg.ensemble_size:
                break
        return [n for n in names if n in self.edges]
