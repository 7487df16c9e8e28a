"""Real-compute inference engine (PyTorch): continuous batching over a
shared KV cache.

The port of the JAX package's `serving/engine.py`. Two KV backends
(`kv_backend`):
  "dense": one max_batch x max_len reservation per slot; a prompt is
      prefilled in one call (`transformer.prefill`) into its slot's rows.
  "paged": a page pool (models/paged_cache.py); pages are allocated on
      demand at admission, appended per decode step, and freed on
      completion; when the pool runs dry the lowest-priority, youngest
      request is evicted and transparently resubmitted. With `host_swap`
      (the default, attention-only stacks) the victim's pages are demoted
      to host memory and promoted back on resume, so decode re-enters
      directly; otherwise (host_swap=False, or a recurrent stack) the
      resume replays prompt + generated tokens (evict-and-replay).
      With `cfg.prefill_chunk > 0` admission queues the prompt and the step
      loop ingests it in chunks, batched ragged over every ingesting slot
      (`ragged_ingest=False`: one chunk a step for the most urgent slot,
      which joins the decode batch in the same step); with
      `prefill_chunk == 0` the prompt is prefilled in one call
      (`transformer.prefill_paged`). `generate_fanout` prefills a shared
      prefix once and forks copy-on-write block-table rows off it. The
      pool stores `cfg.kv_dtype`: the compute dtype by default, another
      float dtype, or int8 / fp8 with a scale per (page, kv head)
      (`cfg.with_(kv_dtype="int8")`; paged backend only).
Dense and paged give the same tokens on the same request stream, and
monolithic and chunked ingest the same to float32 rounding.

The step loop is plan/run: every host decision — page growth, eviction,
ragged ingest rows, decode inputs — is planned with numpy, the block table
is pushed to the device at most once per step, and the step launches at
most one batched ragged ingest call plus one decode-and-sample call. The
decode's tokens and logprobs are read back at the NEXT step's harvest as
one device->host copy; a step in which a prompt's last chunk lands adds one
batched read of those first tokens, as the JAX package's does, and so does
a monolithic admission; a step that demotes a victim adds one read of its
page bytes. Host->device inputs go through pinned memory, so no
step waits on the device otherwise. With monolithic prefill, fork suffixes
and eviction carries are teacher-forced one token a step (`Slot.pending`).

While `repro_torch.trace` records, the engine's host work is spans: each
`step()` is an `engine.step` (attributes: the engine's `name`, `decode`
the decode rows' cached lengths before the step, `ingest` the ragged rows'
(offset, n), `pages` in use after it, `cow` and `new_pages` made by page
growth, `graph` whether a decode graph was replayed and `ingest_graph`
whether the ragged ingest was) over its halves
`engine.readback` (`what`: "decode" or "first_draw"), `engine.commit`,
`engine.plan`, `engine.ingest` and `engine.decode`; `prefill_prefix` is an
`engine.prefix` (`chunks`: the (offset, n) of each prefill call) and an
admission an `engine.admit`.

On a CUDA device the attention reads and the Mamba2 scans run through the
hand-written kernels; on the CPU through their plain versions (tests).
`score()` runs the full-sequence forward through the flash-attention and
SSD-scan wrappers.

Recurrent stacks (Mamba2, and the zamba2 hybrid) prefill monolithically
whatever `cfg.prefill_chunk` says (a scan cannot resume mid-prompt) and
resume evicted requests by replay, as in the JAX package. Two departures
from the JAX engine's results on those stacks, both deliberate: a prompt
is prefilled at its own length, not padded to a bucket, so the recurrent
states are those after the prompt's last token (the JAX engine scans the
padding into them); and decode leaves inactive rows' recurrent states as
they were (the JAX engine advances every row, so a parked prefix that late
forks copy has drifted). Both keep the contracts decode == teacher-forced
forward and fan-out == independent submissions.

`warmup()` prepares an idle engine before a serving window with one
eager, state-neutral dispatch of each step-loop variant the JAX package's
warmup() compiles (the same count). On the card a paged engine also
captures its decode-and-sample step (`transformer.decode_step_paged`,
`sample`, `token_logprob` and the (2, B) pack) as one CUDA graph per live
width, all in one memory pool; from then on every decode step whose live
width was warmed copies its inputs into the graphs' static buffers, draws
the Gumbel noise eagerly from the engine's generator (so a warmed engine
samples draw for draw as a cold one), and replays the graph: one
`cudaGraphLaunch` where a cold step launches every kernel from Python. A
chunked engine with the batched ragged ingest also captures that call
(`transformer.prefill_ragged_paged`) as one graph per row bucket, at the
full block-table width, into the same pool; each ingest then writes its
planned rows into one pinned staging block, moves them to the static
inputs by one copy and replays the bucket's graph. The graphs read the
cache leaves and parameters by address, so a warmed engine raises if one
of them moved to other storage (checked once a step); nothing is captured
again silently, and a failed capture raises. The serial scheduler's chunk,
shared-prefix and monolithic prefill, the dense backend's decode and every
engine on the CPU stay eager.

An encoder-decoder (whisper) raises NotImplementedError: a request
carries tokens only, and the JAX engine passes no frames either. A VLM
(internvl2-2b) is served text-only, as the JAX engine serves it: its
prompts carry no patch embeddings.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels, trace
from repro_torch.kernels import runtime
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.paged_cache import PageAllocator
from repro_torch.serving.requests import BoundedRecord
from repro_torch.serving.sampler import (SamplerConfig, gumbel_noise, sample,
                                         token_logprob)


@dataclasses.dataclass
class Slot:
    req_id: int = -1
    active: bool = False
    tokens: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    max_new: int = 0
    generated: int = 0
    prompt: List[int] = dataclasses.field(default_factory=list)
    ctx_len: int = 0        # tokens currently in the KV cache for this slot
    arrival: int = 0        # admission order (eviction picks the youngest)
    evicted: bool = False   # preempted: requeue instead of completing
    parked: bool = False    # holds a shared prefix for forking, not decoding
    # suffix tokens still to be teacher-forced into the cache (fork path of
    # a monolithic engine): each decode step feeds pending[0] instead of
    # the last sampled token
    pending: List[int] = dataclasses.field(default_factory=list)
    fork_src: int = -1      # parked slot this one was forked from (-1: none)
    suffix: List[int] = dataclasses.field(default_factory=list)
    # prompt (or fork suffix + carried) tokens not yet chunk-ingested: while
    # non-empty the slot is excluded from the decode batch and step() feeds
    # it one chunk at a time; the first sample comes from the final chunk
    prefill_toks: List[int] = dataclasses.field(default_factory=list)
    # eviction priority (higher = more latency-critical, evicted last)
    priority: int = 0
    # the admitted prompt was longer than max_len and kept only its tail
    truncated: bool = False


@dataclasses.dataclass
class StepPlan:
    """Host-side decode plan, computed with numpy only. Token-independent
    state (ctx_len advance, pending-suffix pops) is applied AT PLAN TIME;
    only the sampled token's commit waits for the deferred harvest."""
    active_ids: List[int]           # slots in this decode batch
    last: np.ndarray                # (B, 1) int64 decode inputs
    mask: np.ndarray                # (B,) bool active-row mask
    live: int                       # read width: block-table columns
                                    # (paged) or cache rows (dense)
    commits: List[int]              # slots whose sampled token commits later


@dataclasses.dataclass
class _Resume:
    """A queued request: fresh, or preempted with its generated prefix
    carried. share_from >= 0 routes admission through the COW fork path
    (prompt then holds the full prefix+suffix fallback for eviction resume).
    """
    req_id: int
    prompt: List[int]
    max_new: int
    carry_tokens: List[int]
    carry_lps: List[float]
    share_from: int = -1
    suffix: List[int] = dataclasses.field(default_factory=list)
    priority: int = 0
    # host-tier swap payload (paged backend, host_swap): the victim's page
    # bytes (+ quant scales) snapshotted at demotion, packed into one uint8
    # host tensor (`InferenceEngine._snapshot`), plus the slot state a
    # promote restores verbatim. Non-None routes admission through
    # `_admit_swapped` (one upload and direct decode re-entry) instead of a
    # prefill replay.
    swap: Optional[dict] = None


# Public name for the request-handle admission API (`InferenceEngine
# .try_admit`): the serving front-end builds these for fresh submissions.
EngineRequest = _Resume


# the `what` of an `engine.readback` span
_DECODE = {"what": "decode"}
_FIRST_DRAW = {"what": "first_draw"}


def _bucket(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _pow2_bucket(n: int, hi: int) -> int:
    """Power-of-two bucket from 1, clamped to `hi` (the JAX package's swap
    promote upload widths, and the ragged ingest's row buckets, which
    `warmup()` enumerates)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, hi)


def _tensors(tree):
    """The tensor leaves of nested dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


@dataclasses.dataclass
class _Graph:
    """One captured step: the paged decode-and-sample step at one live
    width, or the batched ragged ingest at one row bucket."""
    graph: "torch.cuda.CUDAGraph"
    # (wrapper, launches) of one replay: a replay runs no Python, so the
    # engine adds these to the wrappers' counters itself
    launches: List[Tuple[object, int]]

    def replay(self) -> None:
        self.graph.replay()
        for wrapper, n in self.launches:
            wrapper.launches += n


def _launch_counts() -> List[Tuple[object, int]]:
    return [(w, w.launches) for w in kernels.wrappers().values()]


def _taken_back(before: List[Tuple[object, int]]) -> List[Tuple[object, int]]:
    """The launches a capture added to the wrappers' counters since
    `before`, taken back (a capture launches nothing) and returned for its
    replays to add."""
    out = []
    for w, n0 in before:
        if w.launches > n0:
            out.append((w, w.launches - n0))
        w.launches = n0
    return out


@dataclasses.dataclass
class _GraphIO:
    """The captured decode's static buffers, allocated before the first
    capture and shared by every graph: its inputs, the Gumbel noise drawn
    eagerly before each replay (temperature > 0 only), and the packed
    (tokens, logprobs) output."""
    tokens: torch.Tensor            # (B, 1) int64
    active: torch.Tensor            # (B,) bool
    noise: Optional[torch.Tensor]   # (B, V) float32
    out: torch.Tensor               # (2, B) float32


class _IngestIO:
    """The captured ingest's static buffers, shared by every row bucket:
    one device block holding the rows' slots, offsets and lens (int32, B
    each) and then their tokens (int64, (B, C)), a pinned host block of the
    same layout that `_replay_ingest` fills, and the (B, V) logits output.
    A bucket of R rows reads the first R entries of each, so one copy of
    the header and R token rows moves a step's inputs. On the card
    `copied` marks the last copy out of the host block, which must have
    run before the block is written again (on the CPU, where the tests
    replay the graphs' body, the copy is synchronous and there is none)."""

    def __init__(self, B: int, C: int, device: torch.device):
        cuda = device.type == "cuda"
        self.header = -(-3 * B * 4 // 16) * 16
        n = self.header + B * C * 8
        self.host = torch.empty(n, dtype=torch.uint8, pin_memory=cuda)
        self.dev = torch.empty(n, dtype=torch.uint8, device=device)
        self.host_ints = self.host[:3 * B * 4].view(torch.int32).view(3, B)
        self.host_tokens = self.host[self.header:].view(torch.int64).view(B, C)
        ints = self.dev[:3 * B * 4].view(torch.int32).view(3, B)
        self.slots, self.offsets, self.lens = ints[0], ints[1], ints[2]
        self.tokens = self.dev[self.header:].view(torch.int64).view(B, C)
        # every row a sentinel (slot B, no tokens): a dispatch over these
        # writes only the scratch page
        self.host.zero_()
        self.host_ints[0] = B
        self.dev.copy_(self.host)
        self.copied = torch.cuda.Event() if cuda else None
        self.logits: Optional[torch.Tensor] = None      # (B, V)


class InferenceEngine:
    """Continuous-batching engine for one model on one device."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_len: int = 1024, sampler: SamplerConfig = SamplerConfig(),
                 eos_id: int = 0, name: str = "engine",
                 kv_backend: str = "paged", page_size: int = 32,
                 n_pages: Optional[int] = None, ragged_ingest: bool = True,
                 host_swap: bool = True, device=None, seed: int = 0):
        if kv_backend not in ("dense", "paged"):
            raise ValueError(f"kv_backend must be 'dense' or 'paged', got "
                             f"{kv_backend!r}")
        if cfg.family == "encdec":
            raise NotImplementedError(
                "the engine serves no encoder-decoder: its requests carry "
                "no frames (neither do the JAX engine's); drive "
                "transformer.prefill / decode_step with enc_frames")
        if kv_backend == "paged":
            transformer.check_paged_supported(cfg)
            cfg.validate_paged(page_size, max_len)
        else:
            if cfg.kv_quantized:
                raise ValueError(f"kv_dtype={cfg.kv_dtype!r} needs the paged "
                                 "backend")
            transformer.check_supported(cfg)
        self.device = runtime.resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.sampler = sampler
        self.eos_id = eos_id
        self.name = name
        self.kv_backend = kv_backend
        # ragged_ingest=False keeps the serial one-chunk-per-step ingest
        # scheduler (the reference for the batched ragged path)
        self.ragged_ingest = ragged_ingest
        # set for a paged attention-only stack below
        self.host_swap = False
        self.slots = [Slot() for _ in range(max_batch)]
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.tokens_generated = 0
        self._arrivals = 0
        self.evictions = 0
        self.peak_pages = 0
        self._window_peak = 0
        self._window_shared = 0
        self._window_logical = 0
        self._resume_queue: List[_Resume] = []
        self._prefix_logits: Dict[int, torch.Tensor] = {}  # parked -> (1, V)
        # per-request time-to-first-token telemetry: admission time survives
        # eviction/resume, recorded once at the first committed token
        self._t_admit: Dict[int, float] = {}
        self._admit_stamp_cap = 4096
        self._inflight: set = set()
        self.ttft: Dict[int, float] = BoundedRecord(self._admit_stamp_cap)
        # req_id -> prompt tokens dropped at admission (prompt > max_len)
        self.truncations: Dict[int, int] = BoundedRecord(self._admit_stamp_cap)
        # deferred harvest: (commit slots, device (2, B) tokens + logprobs)
        # of the decode launched last step(), read back at the next step()
        self._pending_decode: Optional[Tuple[List[int], torch.Tensor]] = None
        self._table_dirty = False
        # fault-injection surfaces (serving/faults.py): step_hook(engine) is
        # called at the top of every step() and may cancel slots, stall, or
        # raise EngineCrash; swap_fault_hook(req_id) -> True marks a swap
        # promote's upload as lost, degrading that resume to evict-and-replay
        self.step_hook = None
        self.swap_fault_hook = None
        self.cancels = 0
        self.deadline_cancels = 0
        # host-tier swap telemetry (paged backend, host_swap)
        self.swap_outs = 0
        self.swap_ins = 0
        self.swap_bytes = 0         # host<->device bytes moved by swaps
        self.swap_losses = 0
        # paged: decode/ingest KV read traffic in bytes (pages touched per
        # step x per-page pool bytes across every attention layer, scales
        # of a quantized pool included)
        self.kv_bytes_read = 0
        # CUDA graphs of the paged decode-and-sample step by live width,
        # captured by warmup() on the card (`_capture_decode`) and replayed
        # by step(); none on the CPU, on the dense backend, or before
        # warmup(), where every step dispatches eagerly
        self._graphs: Dict[int, _Graph] = {}
        self._graph_io: Optional[_GraphIO] = None
        self._graph_stream = None
        self._graph_pool = None
        # what the graphs were captured over: every cache leaf's and
        # parameter's data_ptr, and the sampler (`_check_captured`)
        self._graph_ptrs: Optional[List[int]] = None
        self._graph_sampler: Optional[SamplerConfig] = None
        self.graph_replays = 0
        # CUDA graphs of the batched ragged ingest by row bucket, captured
        # by warmup() on a chunked engine on the card (`_capture_ingest`)
        # and replayed by `_run_ingest`; where none exists the call runs
        # eagerly
        self._ingest_graphs: Dict[int, _Graph] = {}
        self._ingest_io: Optional[_IngestIO] = None
        self.ingest_replays = 0
        # the graphs' pointers were checked this step (`_check_once`)
        self._ptrs_checked = False
        # chunked ingest is the paged backend's and needs an attention-only
        # stack; a dense engine, or a recurrent stack, prefills
        # monolithically whatever cfg.prefill_chunk says
        self.prefill_chunk = 0
        # a recurrent stack's prefill scans every row it is given, padding
        # included: its prompts go in at their own length (`_pad_prompt`)
        self.recurrent = transformer.is_recurrent(cfg)

        if kv_backend == "paged":
            self.page_size = page_size
            self.pages_per_seq = max_len // page_size
            self.n_pages = n_pages or max_batch * self.pages_per_seq
            self.alloc = PageAllocator(self.n_pages, page_size,
                                       self.pages_per_seq)
            self.block_table = np.full((max_batch, self.pages_per_seq), -1,
                                       np.int32)
            self.cache = transformer.init_paged_cache(
                cfg, max_batch, self.n_pages, page_size, self.pages_per_seq,
                device=self.device)
            self.prefill_chunk = 0 if self.recurrent else cfg.prefill_chunk
            # host-tier page swap (demote on eviction, promote on resume)
            # rides the same attention-only gate as chunked prefill:
            # recurrent segments would need their per-slot states
            # snapshotted too, so those stacks keep evict-and-replay
            self.host_swap = host_swap and not self.recurrent
            # bytes one page holds over every attention layer (recurrent
            # states are per slot, not per page)
            self._page_kv_bytes = sum(
                seg[k][:, 0].numel() * seg[k].element_size()
                for seg in transformer.attention_segments(self.cfg, self.cache)
                for k in seg)
        else:
            self.cache = transformer.init_cache(cfg, max_batch, max_len,
                                                device=self.device)

    # ------------------------------------------------------------------
    # Block table and occupancy bookkeeping
    # ------------------------------------------------------------------
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return runtime.host_array_on(arr, self.device)

    def _push_table(self):
        self.cache["block_table"].copy_(self._to_device(self.block_table))
        self._table_dirty = False

    def _mark_table_dirty(self):
        """Host block-table edits are batched: step() pushes the table to
        the device at most ONCE per step (`_sync_table`), right before the
        first launch that reads it. Deferring a freed slot's row clear is
        safe because decode writes are active-masked and masked rows' reads
        are discarded."""
        self._table_dirty = True

    def _sync_table(self):
        if self._table_dirty:
            self._push_table()

    def _occupancy(self) -> Tuple[int, int, int]:
        """(physical, shared, logical) occupancy right now. Dense slots are
        counted as one "page" each with no sharing."""
        if self.kv_backend == "paged":
            return (self.alloc.pages_in_use, self.alloc.pages_shared,
                    self.alloc.logical_pages)
        used = sum(1 for s in self.slots if s.active)
        return used, 0, used

    def _track_peak(self):
        used, shared, logical = self._occupancy()
        self.peak_pages = max(self.peak_pages, used)
        self._window_peak = max(self._window_peak, used)
        self._window_shared = max(self._window_shared, shared)
        self._window_logical = max(self._window_logical, logical)

    def consume_window(self) -> Dict[str, int]:
        """High-water occupancy since the last call, then reset the window
        (the synchronous pipeline drains pools between requests, so only
        the windowed peak carries the pressure signal)."""
        self._track_peak()
        out = {"pages": self._window_peak, "shared": self._window_shared,
               "logical": self._window_logical}
        (self._window_peak, self._window_shared,
         self._window_logical) = self._occupancy()
        return out

    def consume_peak(self) -> int:
        return self.consume_window()["pages"]

    def _release_slot_pages(self, slot: int):
        self.alloc.release(slot)
        self.block_table[slot, :] = -1
        self._mark_table_dirty()

    def _snapshot(self, ids: List[int]) -> torch.Tensor:
        """Pages `ids` of every attention pool, each leaf at its storage
        dtype (a quantized pool's K/V codes and both scale rows), packed
        into one uint8 host tensor by ONE device->host read; each leaf's
        bytes start on 16 bytes (`_swap_payloads` reads them back). The
        host tensor is pinned on the card: a pageable copy runs at a small
        fraction of the pinned rate (PERF.md §6). The pools are written in
        place, so the order matters: the gather is enqueued on the compute
        stream after every launch that wrote these pages, and the blocking
        copy returns only once the bytes are on the host, before this step
        can hand a freed id to another slot and write into it."""
        idx = runtime.host_array_on(np.asarray(ids, np.int64), self.device)
        parts = []
        for seg in transformer.attention_segments(self.cfg, self.cache):
            for leaf in seg.values():
                g = leaf.view(torch.uint8).index_select(1, idx).reshape(-1)
                parts.append(g)
                if g.numel() % 16:
                    parts.append(g.new_zeros(16 - g.numel() % 16))
        packed = torch.cat(parts)
        host = torch.empty(packed.shape, dtype=torch.uint8,
                           pin_memory=packed.is_cuda)
        return host.copy_(packed)

    def _packed_bytes(self, n: int) -> int:
        """Bytes of `_snapshot`'s packed host buffer for n pages."""
        total = 0
        for seg in transformer.attention_segments(self.cfg, self.cache):
            for leaf in seg.values():
                nbytes = leaf[:, 0].numel() * leaf.element_size() * n
                total += nbytes + (-nbytes) % 16
        return total

    def _swap_payloads(self, packed: torch.Tensor, n: int
                       ) -> List[Dict[str, torch.Tensor]]:
        """The inverse of `_snapshot` for `n` pages: one dict per attention
        segment of (count, n, ...) views of `packed` at each leaf's storage
        dtype, on `packed`'s device."""
        out, off = [], 0
        for seg in transformer.attention_segments(self.cfg, self.cache):
            pay = {}
            for k, leaf in seg.items():
                shape = (leaf.shape[0], n) + tuple(leaf.shape[2:])
                nbytes = math.prod(shape) * leaf.element_size()
                pay[k] = packed[off:off + nbytes].view(leaf.dtype).view(shape)
                off += nbytes + (-nbytes) % 16
            out.append(pay)
        return out

    def _evict_victim(self, protect: int) -> bool:
        """Preempt one active slot other than `protect`: the lowest-priority
        one, youngest-first within a priority class, and queue the request
        for resubmission.

        With host_swap its uniquely-owned pages are demoted: their bytes go
        to host memory (`_snapshot`) and the pages back to the pool, while
        shared prefix pages stay resident with a held reference; the resume
        promotes the bytes back and re-enters decode directly, byte-exact,
        with no prefill replay and no draw from the generator. Otherwise its
        unique pages return to the pool (shared prefix pages survive via
        refcounts): a fork whose prefix is still parked resumes through the
        fork path, otherwise `prompt` holds the full prefix+suffix for a
        fresh ingest."""
        victims = [i for i, s in enumerate(self.slots)
                   if s.active and i != protect]
        if not victims:
            return False
        v = min(victims, key=lambda i: (self.slots[i].priority,
                                        -self.slots[i].arrival))
        s = self.slots[v]
        if self.host_swap:
            swapped = self.alloc.demote(v, s.req_id)
            # one device->host read, on an eviction step only
            host = self._snapshot([p for _, p in swapped]) if swapped \
                else None
            self.swap_outs += 1
            self.swap_bytes += len(swapped) * self._page_kv_bytes
            self._resume_queue.append(_Resume(
                req_id=s.req_id, prompt=list(s.prompt), max_new=s.max_new,
                carry_tokens=list(s.tokens), carry_lps=list(s.logprobs),
                priority=s.priority,
                swap={"host": host, "pages": len(swapped),
                      "ctx_len": s.ctx_len, "pending": list(s.pending),
                      "prefill_toks": list(s.prefill_toks),
                      "fork_src": s.fork_src, "suffix": list(s.suffix),
                      "truncated": s.truncated}))
            self.block_table[v, :] = -1
            self._mark_table_dirty()
        else:
            refork = (0 <= s.fork_src < self.max_batch
                      and self.slots[s.fork_src].parked)
            self._resume_queue.append(_Resume(
                req_id=s.req_id, prompt=list(s.prompt), max_new=s.max_new,
                carry_tokens=list(s.tokens), carry_lps=list(s.logprobs),
                share_from=s.fork_src if refork else -1,
                suffix=list(s.suffix) if refork else [],
                priority=s.priority))
            self._release_slot_pages(v)
        s.active, s.evicted, s.req_id = False, True, -1
        s.pending, s.fork_src, s.suffix = [], -1, []
        s.prefill_toks = []     # a mid-prefill victim restarts its chunks
        self.evictions += 1
        return True

    def cancel(self, req_id: int) -> bool:
        """Cancel a mid-flight request: ingesting, decoding, evicted and
        queued, or demoted to the host tier. Frees its pages (COW refcounts
        protect shared prefix pages), drops any host-tier snapshot with the
        resident pages it holds, and prunes its slot from the
        deferred-harvest commit list, so a slot reused by a later admission
        never receives the cancelled request's in-flight token. Survivors
        are untouched: each row's attention reads only its own block-table
        row, decode writes are active-masked, and the engine's generator
        draws noise for every row each step whatever rows are active.
        Returns True if the request was found."""
        hit = False
        for i, s in enumerate(self.slots):
            if s.active and s.req_id == req_id:
                s.active = False
                s.evicted = False
                s.pending, s.prefill_toks = [], []
                s.fork_src, s.suffix = -1, []
                if self.kv_backend == "paged":
                    self._release_slot_pages(i)
                if self._pending_decode is not None:
                    commits, packed = self._pending_decode
                    if i in commits:
                        self._pending_decode = (
                            [c for c in commits if c != i], packed)
                hit = True
        kept = []
        for r in self._resume_queue:
            if r.req_id != req_id:
                kept.append(r)
                continue
            if r.swap is not None:
                self.alloc.drop_hosted(r.req_id)
            hit = True
        self._resume_queue = kept
        if hit:
            self.cancels += 1
            self._t_admit.pop(req_id, None)
        return hit

    def abort_all(self) -> int:
        """Cancel every live request (crash recovery): pages return to the
        pool and host-tier snapshots are dropped. Parked prefix slots are
        left to their owner's release. Returns the number aborted."""
        n = 0
        for s in list(self.slots):
            if s.active:
                self.cancel(s.req_id)
                n += 1
        for r in list(self._resume_queue):
            self.cancel(r.req_id)
            n += 1
        self._pending_decode = None
        return n

    def memory_stats(self) -> Dict[str, float]:
        """Engine-level KV memory telemetry (for RuntimeMonitor). A dense
        engine reports its slots as pages."""
        if self.kv_backend == "paged":
            return {"backend": "paged", "pages_total": self.n_pages,
                    "pages_in_use": self.alloc.pages_in_use,
                    "pages_shared": self.alloc.pages_shared,
                    "pages_logical": self.alloc.logical_pages,
                    "peak_pages": self.peak_pages,
                    "utilization": self.alloc.utilization,
                    "evictions": self.evictions}
        used = sum(1 for s in self.slots if s.active)
        return {"backend": "dense", "pages_total": self.max_batch,
                "pages_in_use": used, "pages_shared": 0,
                "pages_logical": used, "peak_pages": self.max_batch,
                "utilization": used / self.max_batch, "evictions": 0}

    def can_admit(self, prompt_len: int) -> bool:
        """Admission check against real memory, not just a fixed max_batch."""
        if not self.free_slots():
            return False
        if self.kv_backend == "dense":
            return True
        need = max(1, -(-min(prompt_len, self.max_len) // self.page_size))
        return len(self.alloc.free) >= need

    def can_admit_fork(self, src_slot: int, extra_tokens: int = 0) -> bool:
        """Fork admission: a free batch row plus enough free pages for the
        tail copy AND the suffix/carry replay (extra_tokens)."""
        if not self.free_slots():
            return False
        src = self.slots[src_slot]
        total = min(src.ctx_len + extra_tokens, self.max_len)
        full_shared = src.ctx_len // self.page_size
        need = -(-total // self.page_size) - full_shared
        return len(self.alloc.free) >= need

    def can_admit_swap(self, req_id: int) -> bool:
        """Admission check for a demoted request: a free batch row plus
        enough free pages to re-house every swapped page (resident shared
        pages are already held by the hosted entry)."""
        if not self.free_slots():
            return False
        return len(self.alloc.free) >= self.alloc.hosted_pages(req_id)

    def _admit_swapped(self, r: _Resume) -> int:
        """Re-admit a demoted request by promoting its host-tier pages:
        allocate fresh device pages (MemoryError when the pool is dry),
        upload the snapshot in one host->device copy and write it into the
        pools (`transformer.promote_slot_paged`, exactly the swapped pages:
        no bucketed width), rebuild the block-table row, and restore the
        slot so the next step's decode continues from the last sampled
        token. No prefill replay and no draw from the generator."""
        with trace.span("engine.admit") as sp:
            if sp is not None:
                sp.attrs["engine"] = self.name
            slot = self.free_slots()[0]
            self._t_admit.setdefault(r.req_id, time.perf_counter())
            self._prune_admit_stamps()
            # MemoryError if the pool is dry
            uploads = self.alloc.promote(r.req_id, slot)
            chain = self.alloc.owned[slot]
            self.block_table[slot, :] = -1
            self.block_table[slot, :len(chain)] = chain
            self._mark_table_dirty()
            sw = r.swap
            payloads = [] if not uploads else self._swap_payloads(
                sw["host"].to(self.device), sw["pages"])
            self.cache = transformer.promote_slot_paged(
                self.cfg, self.cache, [p for _, p in uploads], payloads, slot,
                sw["ctx_len"])
            self.swap_ins += 1
            self.swap_bytes += sw["pages"] * self._page_kv_bytes
            s = self.slots[slot]
            s.req_id, s.active = r.req_id, True
            s.prompt = list(r.prompt)
            s.tokens, s.logprobs = list(r.carry_tokens), list(r.carry_lps)
            s.max_new, s.generated = r.max_new, len(r.carry_tokens)
            s.ctx_len = sw["ctx_len"]
            s.pending = list(sw["pending"])
            s.prefill_toks = list(sw["prefill_toks"])
            s.fork_src, s.suffix = sw["fork_src"], list(sw["suffix"])
            s.evicted, s.priority = False, r.priority
            s.truncated = sw["truncated"]
            s.arrival = self._arrivals
            self._arrivals += 1
            self._track_peak()
            return slot

    def _live_pages(self, active: List[int]) -> int:
        """Read width for this decode step: enough block-table columns to
        cover every active slot's cache plus the token being written,
        bucketed to the next power of two."""
        return self._chunk_live(max(self.slots[i].ctx_len
                                    for i in active) + 1)

    def _live_rows(self, active: List[int]) -> int:
        """Dense read width for this decode step: the cache rows of every
        active slot plus the token being written, at most the ring's w rows
        for a sliding window. Not bucketed: the port compiles nothing per
        shape, and the kernel takes any width."""
        return min(max(self.slots[i].ctx_len for i in active) + 1,
                   self.cfg.sliding_window or self.max_len)

    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if not s.active and not s.parked]

    def _alloc_slot_pages(self, slot: int, n_tokens: int):
        """Map a fresh page chain for `n_tokens` into the slot's table row."""
        pages = self.alloc.alloc_for(slot, n_tokens)    # MemoryError if dry
        self._track_peak()
        self.block_table[slot, :] = -1
        self.block_table[slot, :len(pages)] = pages
        self._mark_table_dirty()

    def _chunk_live(self, end: int) -> int:
        """Covering read width through position `end`, bucketed to the next
        power of two (shared by the decode step and chunk ingest)."""
        need = -(-min(end, self.max_len) // self.page_size)
        live = 1
        while live < need:
            live *= 2
        return min(live, self.pages_per_seq)

    def _feed_chunk(self, slot: int, chunk: List[int], offset: int):
        """One (1, prefill_chunk)-shaped ingest call: pad, pick the covering
        live width, write+attend the chunk at `offset`. Returns the chunk's
        last-valid-token logits (1, V)."""
        padded = np.zeros((1, self.prefill_chunk), np.int64)
        padded[0, :len(chunk)] = chunk
        live = self._chunk_live(offset + len(chunk))
        self._sync_table()
        logits, self.cache = transformer.prefill_chunk_paged(
            self.cfg, self.params, self._to_device(padded), self.cache,
            slot, offset, len(chunk), live_pages=live)
        return logits

    def _ingest_chunk(self, slot: int):
        """The serial scheduler's step: feed the slot's next prompt chunk
        into the paged cache (`prefill_chunk_paged`). After the final chunk
        the first token is drawn from the chunk's logits, as `_first_draws`
        draws a ragged row's."""
        s = self.slots[slot]
        chunk = s.prefill_toks[:self.prefill_chunk]
        s.prefill_toks = s.prefill_toks[self.prefill_chunk:]
        logits = self._feed_chunk(slot, chunk, s.ctx_len)
        s.ctx_len += len(chunk)
        if not s.prefill_toks:
            self._first_draws([(slot, logits)])

    def _prefill_into_chunks(self, slot: int, toks: List[int]):
        """Synchronous chunked ingest of a whole prompt (prefill_prefix);
        returns final-chunk logits. Draws nothing from the generator. An
        empty prompt ingests one zero-length chunk so callers always get
        logits."""
        C = self.prefill_chunk
        logits = None
        for start in range(0, max(len(toks), 1), C):
            logits = self._feed_chunk(slot, toks[start:start + C], start)
        return logits

    def _prefill_into(self, slot: int, toks: List[int], padded: np.ndarray):
        """Prefill `toks` (right-padded in `padded`, (1, S)) into batch row
        `slot` in one call (chunked on a chunked paged engine); returns
        last-token logits (1, V). A dense engine writes the slot's cache
        rows in place, zero past S, as the JAX package's fresh one-slot
        cache inserted into the batch leaves them."""
        if self.kv_backend == "paged":
            self._alloc_slot_pages(slot, len(toks))
            if self.prefill_chunk:
                return self._prefill_into_chunks(slot, toks)
            self._sync_table()
            logits, self.cache = transformer.prefill_paged(
                self.cfg, self.params, self._to_device(padded), self.cache,
                slot, len(toks))
            return logits
        row = {"lengths": self.cache["lengths"][slot:slot + 1],
               "segments": [{k: seg[k][:, slot:slot + 1] for k in seg}
                            for seg in self.cache["segments"]]}
        logits, _ = transformer.prefill(self.cfg, self.params,
                                        self._to_device(padded), row,
                                        [len(toks)])
        return logits

    def _pad_prompt(self, full_prompt: List[int]):
        """Bucket-pad a prompt, keeping the TAIL when it exceeds max_len.
        Returns (kept_tokens, padded (1, S), dropped). A recurrent stack's
        prompt is not padded (S is its own length, at least 1): its
        prefill would scan the padding into the recurrent states."""
        n = len(full_prompt)
        # repro-analysis: disable=RA201 reason=S is clamped on the next line, S = min(S, self.max_len)
        S = max(n, 1) if self.recurrent else _bucket(n)
        S = min(S, self.max_len)
        padded = np.zeros((1, S), np.int64)
        toks = full_prompt[-S:]
        padded[0, :len(toks)] = toks
        return toks, padded, len(full_prompt) - len(toks)

    # ------------------------------------------------------------------
    # Prefix sharing (PICE sketch fan-out): prefill the shared (query,
    # sketch) prefix ONCE into a parked slot, then fork N copy-on-write
    # block-table rows off it.
    # ------------------------------------------------------------------
    def prefill_prefix(self, prefix: List[int]) -> int:
        """Prefill a shared prefix into a parked slot and return its id for
        `add_request(..., share_from=slot)`. The slot holds its pages (and
        is excluded from scheduling) until `release_prefix`."""
        if self.kv_backend != "paged":
            raise RuntimeError("prefix sharing needs the paged backend")
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot")
        # park in the LAST free slot: forks then land on the same batch rows
        # as independent submissions would
        slot = free[-1]
        with trace.span("engine.prefix") as sp:
            toks, padded, _ = self._pad_prompt(list(prefix))
            if sp is not None:
                # the (offset, n) of each prefill call
                n = len(toks)
                size = self.prefill_chunk or max(n, 1)
                sp.attrs["engine"] = self.name
                sp.attrs["chunks"] = tuple(
                    (o, min(size, n - o)) for o in range(0, max(n, 1), size))
            logits = self._prefill_into(slot, toks, padded)
        s = self.slots[slot]
        s.req_id, s.active, s.parked = -1, False, True
        s.prompt = list(prefix)
        s.tokens, s.logprobs, s.pending, s.prefill_toks = [], [], [], []
        s.ctx_len = len(toks)
        self._prefix_logits[slot] = logits
        return slot

    def release_prefix(self, slot: int) -> None:
        """Free a parked prefix slot; pages shared with live forks survive
        via their refcounts."""
        s = self.slots[slot]
        assert s.parked, "release_prefix on a non-parked slot"
        s.parked = False
        self._prefix_logits.pop(slot, None)
        self._release_slot_pages(slot)

    def _first_draws(self, rows: List[Tuple[int, torch.Tensor]]) -> None:
        """Sample each (slot, (1, V) logits) row's first token, in order,
        and commit them after ONE batched device->host read."""
        draws = []
        for slot, logits in rows:
            tok = sample(logits, self.sampler, self.gen)
            draws.append(torch.stack([tok.float(),
                                      token_logprob(logits, tok)]))
        packed = torch.cat(draws, dim=1)
        with trace.span("engine.readback", _FIRST_DRAW):
            # repro-analysis: disable=RA103 reason=admission's first tokens: one batched read for every slot whose prefill finished this step
            host = packed.cpu().numpy()
        for j, (slot, _) in enumerate(rows):
            self._commit(slot, int(host[0, j]), float(host[1, j]))

    def add_request(self, req_id: int, prompt: List[int], max_new: int,
                    carry_tokens: Optional[List[int]] = None,
                    carry_lps: Optional[List[float]] = None,
                    share_from: Optional[int] = None,
                    suffix: Optional[List[int]] = None,
                    priority: int = 0) -> int:
        """Admit a request. A monolithic engine (dense, or paged with
        `cfg.prefill_chunk == 0`) prefills the prompt now and samples its
        first token; a chunked engine maps the prompt's pages and queues its
        tokens, and `step()` ingests them one chunk per step, batched with
        every other ingesting slot. share_from forks a parked prefix slot
        copy-on-write instead; the fork's `suffix` (the part of the logical
        prompt beyond the shared prefix) plus any carried tokens of a
        preempted fork are ingested in chunks, or teacher-forced one token a
        step on a monolithic engine (`Slot.pending`), and a fork with
        nothing to ingest samples its first token from the prefix logits
        now. `prompt` must be the full logical prompt (prefix + suffix) so
        eviction can always fall back to a fresh prefill. `priority` orders
        eviction (see `_evict_victim`)."""
        with trace.span("engine.admit") as sp:
            if sp is not None:
                sp.attrs["engine"] = self.name
            suffix = list(suffix or [])
            carry_tokens = carry_tokens or []
            carry_lps = carry_lps or []
            if share_from is not None:
                src = self.slots[share_from]
                assert src.parked and share_from in self._prefix_logits, \
                    "share_from must be a parked prefill_prefix slot"
                if src.ctx_len + len(suffix) + len(carry_tokens) \
                        > self.max_len:
                    # would overflow: ingest from scratch
                    share_from = None
            free = self.free_slots()
            if not free:
                raise RuntimeError("no free slot")
            slot = free[0]
            self._t_admit.setdefault(req_id, time.perf_counter())
            self._prune_admit_stamps()

            dropped = 0
            ingest: List[int] = []          # chunked: tokens step() feeds
            pending: List[int] = []         # monolithic fork: teacher-forced
            logits = None
            if share_from is not None:
                src = self.slots[share_from]
                # MemoryError if the tail copy cannot be allocated
                dst_pages, tail_src, tail_dst = self.alloc.fork(
                    share_from, slot, src.ctx_len)
                self._track_peak()
                self.block_table[slot, :] = -1
                self.block_table[slot, :len(dst_pages)] = dst_pages
                self.cache = transformer.fork_slot_paged(
                    self.cfg, self.cache, share_from, slot, tail_src, tail_dst)
                logits = self._prefix_logits[share_from]
                ctx = src.ctx_len
                pending = suffix + carry_tokens
                if self.prefill_chunk and pending:
                    # the replay goes through chunks: map the pages it will
                    # write up front (can_admit_fork gated on this need)
                    target = -(-min(ctx + len(pending), self.max_len)
                               // self.page_size)
                    while len(self.alloc.owned[slot]) < target:
                        p = self.alloc.extend(
                            slot, (len(self.alloc.owned[slot]) + 1)
                            * self.page_size)
                        self.block_table[slot,
                                         len(self.alloc.owned[slot]) - 1] = p
                    self._track_peak()
                    ingest, pending = pending, []
                self._mark_table_dirty()
            elif self.prefill_chunk:
                full = list(prompt) + carry_tokens
                toks = full[-self.max_len:]
                dropped = len(full) - len(toks)
                self._alloc_slot_pages(slot, len(toks))
                ctx, ingest = 0, list(toks)
                if not toks:
                    # degenerate empty prompt: ingest one zero-length chunk now
                    # so the first sample has logits
                    logits = self._prefill_into_chunks(slot, toks)
            else:
                toks, padded, dropped = self._pad_prompt(
                    list(prompt) + carry_tokens)
                logits = self._prefill_into(slot, toks, padded)
                ctx = len(toks)

            s = self.slots[slot]
            s.req_id, s.active = req_id, True
            s.prompt = list(prompt)
            s.tokens, s.logprobs = list(carry_tokens), list(carry_lps)
            s.max_new, s.generated = max_new, len(carry_tokens)
            s.ctx_len = ctx
            s.pending = list(pending)
            s.prefill_toks = list(ingest)
            s.fork_src = share_from if share_from is not None else -1
            s.suffix = suffix if share_from is not None else []
            s.evicted = False
            s.priority = priority
            s.truncated = dropped > 0
            if dropped:
                self.truncations[req_id] = dropped
            s.arrival = self._arrivals
            self._arrivals += 1
            self._track_peak()
            if not s.pending and not s.prefill_toks:
                # sample the first token from the (possibly shared) prefill
                # logits; otherwise it comes after the last ingested token
                self._first_draws([(slot, logits)])
            return slot

    def _prune_admit_stamps(self):
        """Bound `_t_admit` without losing live requests' TTFT: only stamps
        with no remaining reference (active slot, resume queue, a _run loop
        still driving it) are evictable."""
        if len(self._t_admit) <= self._admit_stamp_cap:
            return
        live = {s.req_id for s in self.slots if s.active}
        live |= {r.req_id for r in self._resume_queue}
        live |= self._inflight
        for rid in list(self._t_admit):
            if len(self._t_admit) <= self._admit_stamp_cap:
                break
            if rid not in live:
                self._t_admit.pop(rid)

    def _commit(self, slot: int, tok: int, lp: float):
        s = self.slots[slot]
        s.tokens.append(tok)
        s.logprobs.append(lp)
        s.generated += 1
        self.tokens_generated += 1
        if s.generated == 1 and s.req_id in self._t_admit:
            self.ttft[s.req_id] = (time.perf_counter()
                                   - self._t_admit.pop(s.req_id))
        # context capacity counts as completion: decoding past max_len would
        # overwrite live cache positions
        if (tok == self.eos_id or s.generated >= s.max_new
                or s.ctx_len >= self.max_len):
            s.active = False
            if self.kv_backend == "paged":
                self._release_slot_pages(slot)

    def _grow_pages(self):
        """Before a decode step, make every active slot's next write target
        safe: copy-on-write any shared page the write would land in, and map
        a fresh page when the slot crosses a page boundary; evict the
        lowest-priority youngest request when the pool is dry. Raises
        MemoryError only if a lone request cannot grow. Returns the number
        of pages copied on write and of fresh pages mapped."""
        cows = fresh = 0
        for i, s in enumerate(self.slots):
            if not s.active or s.ctx_len >= self.max_len or s.prefill_toks:
                continue
            cow, cow_done = None, False
            while True:
                try:
                    if not cow_done:
                        cow = self.alloc.cow_page(i, s.ctx_len)
                        cow_done = True
                    newp = self.alloc.extend(i, s.ctx_len + 1)
                    break
                except MemoryError:
                    if not self._evict_victim(protect=i):
                        raise
            if cow is not None:
                old, new = cow
                self.block_table[i, s.ctx_len // self.page_size] = new
                # device-side page copy: fork op with src == dst slot
                self.cache = transformer.fork_slot_paged(
                    self.cfg, self.cache, i, i, old, new)
                cows += 1
                self._track_peak()
            if newp is not None:
                self.block_table[i, len(self.alloc.owned[i]) - 1] = newp
                fresh += 1
                self._track_peak()
        if cows or fresh:
            self._mark_table_dirty()
        return cows, fresh

    def _harvest(self) -> bool:
        """Read back and commit the decode step launched LAST step(): one
        device->host copy of the packed (tokens, logprobs)."""
        if self._pending_decode is None:
            return False
        commits, packed = self._pending_decode
        self._pending_decode = None
        with trace.span("engine.readback", _DECODE):
            host = packed.cpu().numpy()
        with trace.span("engine.commit"):
            for i in commits:
                # the guard covers direct _evict_victim calls (tests)
                if self.slots[i].active:
                    self._commit(i, int(host[0, i]), float(host[1, i]))
        return True

    def _plan_decode(self, active_ids: List[int]) -> StepPlan:
        """Build this step's decode plan with numpy only. A slot with a
        pending suffix is fed pending[0] and commits nothing until the
        suffix is exhausted: the logits after its last token seed the
        first real sample."""
        last = np.zeros((self.max_batch, 1), np.int64)
        mask = np.zeros((self.max_batch,), bool)
        mask[active_ids] = True
        live = self._live_pages(active_ids) \
            if self.kv_backend == "paged" else self._live_rows(active_ids)
        commits: List[int] = []
        for i in active_ids:
            s = self.slots[i]
            if s.pending:
                last[i, 0] = s.pending[0]
            elif s.tokens:
                last[i, 0] = s.tokens[-1]
            s.ctx_len = min(s.ctx_len + 1, self.max_len)
            if s.pending:
                s.pending.pop(0)
                if s.pending:
                    continue            # still teacher-forcing the suffix
            commits.append(i)
        return StepPlan(active_ids=active_ids, last=last, mask=mask,
                        live=live, commits=commits)

    def _decode_sample(self, tokens: torch.Tensor, active: torch.Tensor,
                       live: int, noise: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """One decode step + sample + logprob on the device at read width
        `live`, packed (2, B) as (tokens, logprobs). Sampling draws its
        Gumbel noise from the engine's generator unless `noise` is given."""
        if self.kv_backend == "paged":
            logits, self.cache = transformer.decode_step_paged(
                self.cfg, self.params, tokens, self.cache, active=active,
                live_pages=live)
        else:
            logits, self.cache = transformer.decode_step(
                self.cfg, self.params, tokens, self.cache, active=active,
                live_rows=live)
        toks = sample(logits, self.sampler, self.gen, noise=noise)
        return torch.stack([toks.float(), token_logprob(logits, toks)])

    def _dispatch_decode(self, plan: StepPlan) -> bool:
        """The "run" half: one decode step + sample + logprob on the device,
        read back at the next step's harvest; the captured graph of the
        plan's live width is replayed when warmup() captured one. Returns
        whether a graph was replayed."""
        if self.kv_backend == "paged":
            self.kv_bytes_read += self._page_kv_bytes * sum(
                -(-self.slots[i].ctx_len // self.page_size)
                for i in plan.active_ids)
        graph = self._graphs.get(plan.live)
        with trace.span("engine.decode"):
            if graph is not None:
                packed = self._replay_decode(graph, plan)
            else:
                packed = self._decode_sample(self._to_device(plan.last),
                                             self._to_device(plan.mask),
                                             plan.live)
        self._pending_decode = (plan.commits, packed)
        return graph is not None

    def _replay_decode(self, graph: _Graph, plan: StepPlan) -> torch.Tensor:
        """Replay a captured decode-and-sample step: the plan's inputs are
        copied into the static buffers through pinned memory, the Gumbel
        noise is drawn eagerly from the engine's generator (the draw a cold
        engine makes inside `sample`, whatever a capture would do with the
        generator), and the wrappers' counters take the replay's launches.
        Returns a clone of the packed output."""
        self._check_once()
        io = self._graph_io
        io.tokens.copy_(torch.from_numpy(plan.last).pin_memory(),
                        non_blocking=True)
        io.active.copy_(torch.from_numpy(plan.mask).pin_memory(),
                        non_blocking=True)
        if io.noise is not None:
            gumbel_noise(io.noise.shape, self.gen, self.device, out=io.noise)
        graph.replay()
        self.graph_replays += 1
        # cloned: the next replay rewrites io.out, and this step's result is
        # read only at the next step's harvest; the clone keeps it whatever
        # runs in between
        return io.out.clone()

    def _check_captured(self) -> None:
        """The graphs hold raw pointers: raise if a cache leaf or a
        parameter now lies in other storage than at their capture, or the
        sampler they sample with changed. Nothing is captured again
        silently."""
        if self.sampler != self._graph_sampler:
            raise RuntimeError(
                f"the sampler changed from {self._graph_sampler} to "
                f"{self.sampler} after the decode graphs were captured")
        ptrs = [t.data_ptr() for t in _tensors((self.cache, self.params))]
        if ptrs != self._graph_ptrs:
            raise RuntimeError(
                "a cache leaf or parameter moved to other storage after the "
                "graphs were captured over it: update tensors in place on a "
                "warmed engine")

    def _check_once(self) -> None:
        """`_check_captured` before a step's first replay, ingest or decode:
        nothing the engine does inside a step moves a leaf."""
        if not self._ptrs_checked:
            self._check_captured()
            self._ptrs_checked = True

    def _capture_stream(self):
        """The stream every capture runs on, made with the graph pool that
        every graph shares at the first capture, when the pointers and the
        sampler the graphs are held to are taken; a later capture checks
        them instead."""
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph_ptrs = [t.data_ptr() for t in
                                _tensors((self.cache, self.params))]
            self._graph_sampler = self.sampler
        else:
            self._check_captured()
        return self._graph_stream

    def _on_stream(self, stream, body) -> None:
        """Run `body` eagerly on `stream`, ordered after and before the
        current stream's work."""
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            body()
        current.wait_stream(stream)

    def _capture_decode(self, live: int) -> None:
        """Warm the paged decode-and-sample step at read width `live` on the
        card and capture it as a CUDA graph into the engine's graph pool,
        shared by every live width: first one eager dispatch on the capture
        stream (PyTorch's rule before a capture; the dispatch `warmup()`
        counts), then the capture, unless this width has its graph. The
        static inputs are zeroed first, every row inactive, so the eager
        dispatch writes only the scratch page. A capture launches nothing:
        the counts it added to the wrappers' counters are taken back and
        kept for its replays. A failed capture raises."""
        B = self.max_batch
        stream = self._capture_stream()
        if self._graph_io is None:
            noise = None
            if self.sampler.temperature > 0:
                noise = torch.zeros((B, self.cfg.vocab_size),
                                    dtype=torch.float32, device=self.device)
            self._graph_io = _GraphIO(
                tokens=torch.zeros((B, 1), dtype=torch.int64,
                                   device=self.device),
                active=torch.zeros(B, dtype=torch.bool, device=self.device),
                noise=noise,
                out=torch.zeros((2, B), dtype=torch.float32,
                                device=self.device))
        io = self._graph_io
        io.tokens.zero_()
        io.active.zero_()

        def body():
            io.out.copy_(self._decode_sample(io.tokens, io.active, live,
                                             io.noise))
        self._on_stream(stream, body)
        if live in self._graphs:
            return
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool, stream=stream):
            body()
        self._graphs[live] = _Graph(graph, _taken_back(before))

    def _ingest(self, rows: int) -> None:
        """The batched ragged ingest over the first `rows` rows of the
        static buffers at the full block-table width, its logits into the
        static output: the body of an ingest graph."""
        io = self._ingest_io
        logits, self.cache = transformer.prefill_ragged_paged(
            self.cfg, self.params, io.tokens[:rows], self.cache,
            io.slots[:rows], io.offsets[:rows], io.lens[:rows],
            live_pages=self.pages_per_seq)
        io.logits[:rows].copy_(logits)

    def _capture_ingest(self, rows: int) -> None:
        """Capture the batched ragged ingest at row bucket `rows` as a CUDA
        graph into the engine's graph pool, at the full block-table width:
        the attention kernel's key loop ends at each row's offset + length
        and the write plans drop every position past it, so the width
        changes no work and no number against the eager call at its live
        width. The first capture allocates the static buffers (`_IngestIO`)
        and makes one eager dispatch of one sentinel row on the capture
        stream, which writes only the scratch page and gives the logits
        output its dtype. A failed capture raises."""
        stream = self._capture_stream()
        if self._ingest_io is None:
            io = _IngestIO(self.max_batch, self.prefill_chunk, self.device)
            self._ingest_io = io

            def probe():
                logits, self.cache = transformer.prefill_ragged_paged(
                    self.cfg, self.params, io.tokens[:1], self.cache,
                    io.slots[:1], io.offsets[:1], io.lens[:1],
                    live_pages=self.pages_per_seq)
                io.logits = torch.empty((self.max_batch, logits.shape[1]),
                                        dtype=logits.dtype,
                                        device=self.device)
            self._on_stream(stream, probe)
        if rows in self._ingest_graphs:
            return
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool, stream=stream):
            self._ingest(rows)
        self._ingest_graphs[rows] = _Graph(graph, _taken_back(before))

    def _replay_ingest(self, graph: _Graph, toks: np.ndarray,
                       slots: np.ndarray, offs: np.ndarray, lens: np.ndarray
                       ) -> torch.Tensor:
        """Replay the captured ingest of the rows' bucket: the planned rows
        go into the pinned staging block, once the last copy out of it has
        run (it has, unless the device is a whole ingest call behind, which
        only steps that ingest alone allow), and to the static inputs by one
        copy; the wrappers' counters take the replay's launches. Returns the
        rows' logits: a view of the static output, which the next replay
        rewrites after the current stream has read it."""
        self._check_once()
        io = self._ingest_io
        R = len(slots)
        if io.copied is not None:
            # repro-analysis: disable=RA104 reason=waits for the last copy out of the persistent staging block before rewriting it; that copy has run unless the device lags a whole ingest call
            io.copied.synchronize()
        io.host_ints[:, :R].copy_(torch.from_numpy(np.stack([slots, offs,
                                                              lens])))
        io.host_tokens[:R].copy_(torch.from_numpy(toks))
        n = io.header + toks.nbytes
        io.dev[:n].copy_(io.host[:n], non_blocking=True)
        if io.copied is not None:
            io.copied.record()
        graph.replay()
        self.ingest_replays += 1
        return io.logits[:R]

    def _run_ingest(self) -> Tuple[List[Tuple[int, int, List[int]]], bool]:
        """Batched ragged chunk ingest: EVERY ingesting slot's next chunk in
        one `prefill_ragged_paged` call, bucketed to R = min(the next power
        of two, max_batch) rows; the bucket's captured graph is replayed
        when warmup() captured one. Slots whose final chunk lands here draw
        their first token now, in (priority, admission) order, and join the
        decode batch next step. Returns the rows ingested, (slot, offset,
        chunk) in launch order, and whether a graph was replayed."""
        ing = [i for i, s in enumerate(self.slots)
               if s.active and s.prefill_toks]
        if not ing:
            return [], False
        ing.sort(key=lambda j: (-self.slots[j].priority,
                                self.slots[j].arrival))
        C = self.prefill_chunk
        rows: List[Tuple[int, int, List[int]]] = []
        for i in ing:
            s = self.slots[i]
            chunk = s.prefill_toks[:C]
            s.prefill_toks = s.prefill_toks[C:]
            rows.append((i, s.ctx_len, chunk))
            s.ctx_len += len(chunk)
        R = _pow2_bucket(len(rows), self.max_batch)
        toks = np.zeros((R, C), np.int64)
        # padding rows carry the out-of-range slot `max_batch`: their cache
        # writes drop and their reads are discarded
        slots = np.full((R,), self.max_batch, np.int32)
        offs = np.zeros((R,), np.int32)
        lens = np.zeros((R,), np.int32)
        for r, (i, off, chunk) in enumerate(rows):
            toks[r, :len(chunk)] = chunk
            slots[r], offs[r], lens[r] = i, off, len(chunk)
        live = self._chunk_live(max(off + len(chunk)
                                    for _, off, chunk in rows))
        self.kv_bytes_read += self._page_kv_bytes * sum(
            -(-(off + len(chunk)) // self.page_size)
            for _, off, chunk in rows)
        graph = self._ingest_graphs.get(R)
        with trace.span("engine.ingest"):
            if graph is not None:
                logits = self._replay_ingest(graph, toks, slots, offs, lens)
            else:
                logits, self.cache = transformer.prefill_ragged_paged(
                    self.cfg, self.params, self._to_device(toks), self.cache,
                    slots, offs, lens, live_pages=live)
        finished = [(i, logits[r:r + 1]) for r, (i, _, _) in enumerate(rows)
                    if self.slots[i].active and not self.slots[i].prefill_toks]
        if finished:
            self._first_draws(finished)
        return rows, graph is not None

    def step(self) -> bool:
        """One engine step, structured plan/run: (0) harvest last step's
        decode readback, (1) host-plan page growth/COW, eviction, ragged
        ingest rows and decode inputs with numpy, (2) push the block table
        at most once, (3) launch at most one batched ragged ingest call and
        one decode call, deferring the decode readback to the next step.
        With `ragged_ingest=False` the serial scheduler instead feeds one
        chunk of the most urgent ingesting slot first, through
        `prefill_chunk_paged`, and that slot joins this step's decode batch
        when its last chunk lands (its block-table row is pushed for the
        chunk). Returns True if work was done (including a harvest-only
        step)."""
        with trace.span("engine.step") as sp:
            self._ptrs_checked = False
            if self.step_hook is not None:
                self.step_hook(self)
            worked = self._harvest()
            if not any(s.active for s in self.slots):
                if sp is not None:
                    sp.attrs["engine"] = self.name
                return worked
            paged = self.kv_backend == "paged"
            batched = self.prefill_chunk and self.ragged_ingest
            chunks = ()         # (offset, n) of each chunk ingested
            if self.prefill_chunk and not batched:
                # serial scheduler: one chunk for the most urgent ingesting
                # slot (highest priority, then oldest admission), which
                # joins the decode batch this same step
                with trace.span("engine.plan"):
                    pref = [i for i, s in enumerate(self.slots)
                            if s.active and s.prefill_toks]
                    j = min(pref, key=lambda j: (-self.slots[j].priority,
                                                 self.slots[j].arrival)) \
                        if pref else None
                if j is not None:
                    if sp is not None:
                        s = self.slots[j]
                        chunks = ((s.ctx_len, min(len(s.prefill_toks),
                                                  self.prefill_chunk)),)
                    with trace.span("engine.ingest"):
                        self._ingest_chunk(j)
                    worked = True
            with trace.span("engine.plan"):
                active = [i for i, s in enumerate(self.slots)
                          if s.active and not s.prefill_toks]
                grown = (0, 0)
                if paged and active:
                    # may evict, incl. mid-ingest slots
                    grown = self._grow_pages()
                    active = [i for i, s in enumerate(self.slots)
                              if s.active and not s.prefill_toks]
                if sp is not None:
                    decode = tuple(self.slots[i].ctx_len for i in active)
                plan = self._plan_decode(active) if active else None
                if paged:
                    # ONE table push per step, before the first launch that
                    # reads it
                    self._sync_table()
            ingest_replayed = False
            if batched:
                rows, ingest_replayed = self._run_ingest()
                if sp is not None:
                    chunks = tuple((off, len(c)) for _, off, c in rows)
                worked = bool(rows) or worked
            replayed = False
            if plan is not None:
                replayed = self._dispatch_decode(plan)
                worked = True
            if sp is not None:
                sp.attrs.update(engine=self.name, decode=decode,
                                ingest=chunks, cow=grown[0],
                                new_pages=grown[1], graph=replayed,
                                ingest_graph=ingest_replayed)
                if paged:
                    sp.attrs["pages"] = self.alloc.pages_in_use
            return worked

    def warmup(self, *, max_context: Optional[int] = None,
               prompt_lens: Tuple[int, ...] = (),
               ingest_rows: Tuple[int, ...] = (1,)) -> int:
        """Prepare the step loop's variants on an IDLE engine, so that the
        first serving window pays no first-use cost, and return the number
        of variant dispatches made: the JAX engine's count for the same
        config and arguments, one eager dispatch for each jit variant its
        warmup() compiles.

        max_context bounds the decode live widths to warm (default max_len);
        prompt_lens warms monolithic prefill at their buckets (dense and
        non-chunked paged engines) and score() at the same buckets;
        ingest_rows warms batched ragged ingest at their row buckets, each
        at every live width (chunked paged engines; the serial scheduler
        warms its one-slot chunk at every live width instead). A paged
        engine also warms the fork copy and, with host_swap, a promote at
        every upload-width bucket. On the card the kernels are built first
        (`runtime.build_all()`), and the dispatches pay the library handles,
        the allocator's segments, the pinned host blocks of each promote
        width and the decode kernel's cached occupancy and shared-memory
        limit. A paged engine on the card also captures its decode-and-
        sample step as one CUDA graph per live width (`_capture_decode`),
        which step() then replays, and a chunked one with the batched
        ragged ingest that call at every row bucket min(2^k, max_batch)
        (`_capture_ingest`), whatever `ingest_rows` says: no step ingests
        more rows than there are slots. The captures add nothing to the
        count.

        State-neutral: the generator is not drawn from, and nothing is
        written but the scratch page. Decode runs with every row inactive,
        ragged ingest with sentinel rows (slot max_batch), the serial chunk
        and monolithic prefill with zero-length prompts, the promote into
        the scratch page; the cached length and recurrent states of the
        batch row a variant must name are restored after it. A dense
        engine's decode rows are restored after its write, and its prefill
        runs into a one-slot cache of its own."""
        assert not any(s.active or s.parked for s in self.slots), \
            "warmup requires an idle engine"
        dev, B = self.device, self.max_batch
        if dev.type == "cuda":
            runtime.build_all()
        count = 0
        buckets = sorted({min(_bucket(n), self.max_len) for n in prompt_lens})
        if self.kv_backend == "paged":
            lives = sorted({self._chunk_live(end) for end in
                            range(1, min(max_context or self.max_len,
                                         self.max_len) + 1)})
            for live in lives:
                if dev.type == "cuda":
                    self._capture_decode(live)
                else:
                    self._decode_sample(
                        torch.zeros((B, 1), dtype=torch.int64, device=dev),
                        torch.zeros(B, dtype=torch.bool, device=dev), live,
                        self._warm_noise())
                count += 1
            C = self.prefill_chunk
            if C and self.ragged_ingest:
                for rb in sorted({_pow2_bucket(n, B) for n in ingest_rows}):
                    toks = torch.zeros((rb, C), dtype=torch.int64, device=dev)
                    sent = np.full((rb,), B, np.int32)
                    zero = np.zeros((rb,), np.int32)
                    for live in lives:
                        transformer.prefill_ragged_paged(
                            self.cfg, self.params, toks, self.cache, sent,
                            zero, zero, live_pages=live)
                        count += 1
                if dev.type == "cuda":
                    # the largest bucket first: the smaller captures then
                    # reuse the pool memory it freed
                    for rb in sorted({_pow2_bucket(n, B)
                                      for n in range(1, B + 1)},
                                     reverse=True):
                        self._capture_ingest(rb)
            elif C:
                toks = torch.zeros((1, C), dtype=torch.int64, device=dev)
                for live in lives:
                    with self._row_kept(0):
                        transformer.prefill_chunk_paged(
                            self.cfg, self.params, toks, self.cache, 0, 0, 0,
                            live_pages=live)
                    count += 1
            else:
                for S in buckets:
                    with self._row_kept(0):
                        transformer.prefill_paged(
                            self.cfg, self.params,
                            torch.zeros((1, S), dtype=torch.int64,
                                        device=dev), self.cache, 0, 0)
                    count += 1
            # the fork copy: src == dst copies nothing on an idle engine
            self.cache = transformer.fork_slot_paged(self.cfg, self.cache,
                                                     0, 0, 0, 0)
            count += 1
            if self.host_swap:
                # one promote at each upload-width bucket, every id the
                # scratch page; the length it sets is restored
                for U in sorted({_pow2_bucket(u, self.pages_per_seq)
                                 for u in range(1, self.pages_per_seq + 1)}):
                    host = torch.zeros(self._packed_bytes(U),
                                       dtype=torch.uint8,
                                       pin_memory=dev.type == "cuda")
                    with self._row_kept(0):
                        transformer.promote_slot_paged(
                            self.cfg, self.cache, [self.n_pages] * U,
                            self._swap_payloads(host.to(dev), U), 0, 0)
                    count += 1
        else:
            self._warm_dense_decode()
            count += 1
            for S in buckets:
                one = transformer.init_cache(self.cfg, 1, self.max_len,
                                             device=dev)
                transformer.prefill(self.cfg, self.params,
                                    torch.zeros((1, S), dtype=torch.int64,
                                                device=dev), one, [S])
                count += 1
        for S in buckets:
            self.score([self.eos_id] * S)
            count += 1
        return count

    def _warm_noise(self) -> Optional[torch.Tensor]:
        """Zero Gumbel noise for a warm dispatch's sample, which must not
        draw from the engine's generator (None for greedy sampling)."""
        if self.sampler.temperature <= 0:
            return None
        return torch.zeros((self.max_batch, self.cfg.vocab_size),
                           dtype=torch.float32, device=self.device)

    @contextlib.contextmanager
    def _row_kept(self, slot: int):
        """Restore batch row `slot`'s cached length and recurrent states
        after the body: a warm variant that must name a real row."""
        rows = [self.cache["lengths"][slot:slot + 1]] + [
            leaf[:, slot]
            for seg in transformer.state_segments(self.cfg, self.cache)
            for leaf in seg.values()]
        saved = [r.clone() for r in rows]
        try:
            yield
        finally:
            for r, v in zip(rows, saved):
                r.copy_(v)

    def _warm_dense_decode(self) -> None:
        """A dense engine's decode-and-sample dispatch with every row
        inactive. Its K/V writes land at each slot's length (clamped, or
        wrapped in a ring, as `cache.write_plan` does), so those rows are
        restored after it."""
        dev, B = self.device, self.max_batch
        attn = transformer.attention_segments(self.cfg, self.cache)
        kept = []
        if attn:
            S = attn[0]["k"].shape[2]
            rows = torch.arange(B, device=dev)
            at = self.cache["lengths"].long()
            at = at % S if self.cfg.sliding_window else at.clamp(0, S - 1)
            kept = [(leaf, leaf[:, rows, at].clone()) for seg in attn
                    for leaf in seg.values()]
        self._decode_sample(torch.zeros((B, 1), dtype=torch.int64, device=dev),
                            torch.zeros(B, dtype=torch.bool, device=dev),
                            self.max_len, self._warm_noise())
        for leaf, v in kept:
            leaf[:, rows, at] = v

    # ------------------------------------------------------------------
    def generate(self, prompts: List[List[int]], max_new: int = 128,
                 priorities: Optional[List[int]] = None,
                 deadline_s: Optional[float] = None
                 ) -> List[Tuple[List[int], List[float]]]:
        """Batch-generate; returns (tokens, logprobs) per prompt.
        `priorities` orders preemption under memory pressure; `deadline_s`
        (perf_counter timestamp) caps the run, returning partials."""
        priorities = priorities or [0] * len(prompts)
        assert len(priorities) == len(prompts), \
            "priorities must match prompts one-to-one"
        pending = [_Resume(req_id=i, prompt=p, max_new=max_new,
                           carry_tokens=[], carry_lps=[], priority=pr)
                   for i, (p, pr) in enumerate(zip(prompts, priorities))]
        return self._run(pending, deadline_s=deadline_s)

    def generate_fanout(self, prefix: List[int],
                        suffixes: List[List[int]], max_new: int = 128,
                        priority: int = 0,
                        deadline_s: Optional[float] = None
                        ) -> List[Tuple[List[int], List[float]]]:
        """Expand one shared prefix N ways (the PICE sketch fan-out): the
        prefix is prefilled ONCE and each expansion forks a copy-on-write
        block-table row off it; per-group suffixes are ingested before
        sampling. Falls back to independent submissions on the dense
        backend, which cannot share pages, and on a 1-slot engine, which
        has no second slot to fork into."""
        if self.kv_backend != "paged" or self.max_batch < 2:
            return self.generate([list(prefix) + list(s) for s in suffixes],
                                 max_new=max_new,
                                 priorities=[priority] * len(suffixes),
                                 deadline_s=deadline_s)
        p_slot = self.prefill_prefix(prefix)
        pending = [_Resume(req_id=i, prompt=list(prefix) + list(sfx),
                           max_new=max_new, carry_tokens=[], carry_lps=[],
                           share_from=p_slot, suffix=list(sfx),
                           priority=priority)
                   for i, sfx in enumerate(suffixes)]
        try:
            return self._run(pending, deadline_s=deadline_s)
        finally:
            self.release_prefix(p_slot)

    def _run(self, pending: List[_Resume],
             deadline_s: Optional[float] = None
             ) -> List[Tuple[List[int], List[float]]]:
        n = len(pending)
        for r in pending:
            self._t_admit.pop(r.req_id, None)
        mine = {r.req_id for r in pending}
        self._inflight |= mine
        try:
            return self._run_inner(pending, n, deadline_s)
        finally:
            self._inflight -= mine

    # ------------------------------------------------------------------
    # Request-handle admission API: the synchronous `_run` loop and the
    # async serving front-end (serving/frontend.py) drive the engine
    # through these same two calls.
    # ------------------------------------------------------------------
    def try_admit(self, r: _Resume) -> Optional[int]:
        """Attempt to admit `r`. Returns the slot index on success, or None
        when the request must wait for slots/pages to free. Raises
        MemoryError when the engine is IDLE and the request still cannot
        fit.

        May mutate `r`: a lost swap upload (`swap_fault_hook`) degrades a
        host-tier resume to evict-and-replay (r.prompt and the carried
        tokens are what a replay eviction queues); a fork resume whose
        parked prefix is gone falls back to a fresh ingest of its full
        prompt."""
        if not self.free_slots():
            return None
        if r.swap is not None and self.swap_fault_hook is not None \
                and self.swap_fault_hook(r.req_id):
            self.alloc.drop_hosted(r.req_id)
            r.swap = None
            self.swap_losses += 1
        if r.swap is not None:
            # demoted request: promote its pages and re-enter decode
            if not self.can_admit_swap(r.req_id):
                if not any(s.active for s in self.slots):
                    raise MemoryError(
                        f"request {r.req_id} cannot fit in the page pool")
                return None                      # wait for pages to free
            return self._admit_swapped(r)
        if r.share_from >= 0 and not self.slots[r.share_from].parked:
            r.share_from, r.suffix = -1, []       # prefix gone: from scratch
        if r.share_from >= 0:
            ok = self.can_admit_fork(
                r.share_from, len(r.suffix) + len(r.carry_tokens))
        else:
            ok = self.can_admit(len(r.prompt) + len(r.carry_tokens))
        if not ok:
            if not any(s.active for s in self.slots):
                raise MemoryError(
                    f"request {r.req_id} cannot fit in the page pool")
            return None                          # wait for pages to free
        return self.add_request(
            r.req_id, r.prompt, r.max_new,
            carry_tokens=r.carry_tokens, carry_lps=r.carry_lps,
            share_from=r.share_from if r.share_from >= 0 else None,
            suffix=r.suffix, priority=r.priority)

    def drain_resumes(self) -> List[_Resume]:
        """Take the work eviction preempted, oldest victim first."""
        out = list(reversed(self._resume_queue))
        self._resume_queue.clear()
        return out

    def _run_inner(self, pending: List[_Resume], n: int,
                   deadline_s: Optional[float] = None
                   ) -> List[Tuple[List[int], List[float]]]:
        results: Dict[int, Tuple[List[int], List[float]]] = {}
        submitted: Dict[int, int] = {}          # req_id -> slot
        while pending or any(s.active for s in self.slots):
            while pending and self.free_slots():
                slot = self.try_admit(pending[0])
                if slot is None:
                    break                        # wait for pages to free
                r = pending.pop(0)
                submitted[r.req_id] = slot
            self.step()
            if deadline_s is not None and time.perf_counter() > deadline_s \
                    and (pending or any(s.active for s in self.slots)):
                # deadline blown: cancel every in-flight request (partial
                # tokens are collected below) and settle queued work with
                # whatever it carried
                for rid, sl in list(submitted.items()):
                    if self.slots[sl].active:
                        self.cancel(rid)
                        self.deadline_cancels += 1
                pending[:0] = self.drain_resumes()
                for r in pending:
                    if r.swap is not None:
                        self.alloc.drop_hosted(r.req_id)
                    results[r.req_id] = (list(r.carry_tokens),
                                         list(r.carry_lps))
                    self.deadline_cancels += 1
                pending.clear()
            done = [rid for rid, sl in submitted.items()
                    if not self.slots[sl].active]
            for rid in done:
                sl = submitted.pop(rid)
                s = self.slots[sl]
                s.req_id = -1
                if s.evicted:
                    s.evicted = False
                    continue                     # resubmitted via _resume_queue
                results[rid] = (list(s.tokens), list(s.logprobs))
            pending[:0] = self.drain_resumes()
        return [results[i] for i in range(n)]

    def score(self, tokens: List[int]) -> Tuple[float, np.ndarray]:
        """Mean token logprob of a sequence under this model (perplexity),
        teacher-forced through `transformer.forward`.

        The scoring buffer is clamped to max_len: a sequence beyond it is
        scored on its TAIL, the convention `_pad_prompt` applies. Returns
        (mean, per-token logprobs of tokens[1:])."""
        S = min(_bucket(len(tokens)), self.max_len)
        toks = tokens[-S:]
        arr = np.full((S,), self.eos_id, np.int64)
        arr[:len(toks)] = toks
        dev = self._to_device(arr)
        logits, _ = transformer.forward(self.cfg, self.params, dev[None, :-1])
        logp = torch.log_softmax(logits[0].float(), dim=-1)
        gold = logp.gather(-1, dev[1:, None])[:, 0]
        # repro-analysis: disable=RA103 reason=score() runs outside the step loop: one read of the per-token logprobs a call
        gold = gold.cpu().numpy()[:max(len(toks) - 1, 1)]
        return float(np.mean(gold)), gold
