#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. It builds the hand-written CUDA kernels from
`src/repro_torch/csrc/` with nvcc (into `build/`), then:

  1. environment: the card, its power limit, torch/CUDA versions, build time
     (every source rebuilt), each kernel function's registers, spilled
     bytes and static shared memory as ptxas reports them, held to sm_90's
     255 registers and 227 KB (spills are logged, not failed); TF32 is
     switched off for float32 matmuls and convolutions;
  2. every kernel wrapper against its plain PyTorch version on the card, on
     the case families of the JAX package's kernel tests; the tensor-core
     decode kernel (a bf16 query over bf16, int8 and fp8 pools, and a bf16
     dense cache) at q_per_kv 1/2/4/6/16/24, head_dim 16/24/36/80/128/256,
     pages 8/12/32/64, splits of 1 and at the cluster cap, a slot of 4,096
     keys, NaN or 127 past each length, -1 pages, a zero-length slot,
     COW-shared pages, a dense cache slice of S = 200; for the paged
     kernels ragged lengths with 0, unmapped -1 tail pages, COW-shared
     pages, padding ingest rows (head_dim 24/32/128, q_per_kv 1/2/4/6, page
     8/16/32, chunk 16/48/64/128); the same over int8 and fp8 pools (the
     `_quant` wrappers; head_dim 16/24/32/128, a chunk starting mid-page,
     NaN or the extreme value stored past each length), and the float
     wrappers over a bf16 pool under a float32 query; the tensor-core
     prefill kernel (a bf16 query over bf16, int8 and fp8 pools) at page
     12 and 64, head_dim 24/36/80/128/256, q_per_kv 1/4/6/16/72, chunks of
     37 and 40, NaN or the extreme value past each length, with one and
     with two key groups a block; for the dense decode
     kernel ragged lengths from 1 to S with NaN past each length and a slot
     of length 0, and a sliding-window ring laid out as the port's prefill
     lays it (w = 64, totals short of, at and past the window, NaN in the
     rows no position reached) against the JAX package's plain ring mask; for the flash kernel window 0/64, softcap 0/30, causal
     and not, S of 200 and 300, whisper-tiny's encoder (B 1 and 8 x S
     1,500, 6 heads of 64, not causal) and decoder (B 8 x S 256, causal)
     and internvl2-2b's prefill (B 8 x S 288, 16 query over 8 KV heads of
     128, causal) in float32 and bfloat16, and its tensor-core kernel (bf16) at
     q_per_kv 1/4/6/16/72, head_dim 64/80/128/256, S 1/37/200/1000 under
     six masks, in each of its launch shapes; zamba2's attention (head_dim
     80, q_per_kv 1) through the paged, dense-decode, flash and int8 decode
     kernels; a float32 query at rtol=atol=2e-5 and bfloat16 at
     rtol=atol=2e-2; the
     SSD scan on the JAX kernel test's cases, ragged S (37, 1000),
     TINY_EDGE_C's and zamba2's heads and an initial state, and the edges
     of its cluster split (S 1/63/65/129, P 4 with N 8, an initial state
     crossing ranks, strong decays, one rank over a batch that fills the
     card, segments longer than a super-chunk at S 1,500 and 2,048; the
     planner's R logged for each) at rtol=atol=1e-4; RMSNorm in float32
     and bfloat16 at D 96 to 5120 (the served widths among them) and 1 to
     1027 rows; the three backward kernels (RMSNorm #10b, flash attention
     #7b, the SSD scan #9b) through their wrappers' autograd Functions
     against torch.autograd through the plain versions, at tiny and
     full-width shapes (qwen2-1.5b's B 8 x S 256 rows and heads, zamba2's
     head_dim 80 at q_per_kv 1 and its 80 SSD heads at B 2 x S 256),
     flash with and without window and softcap at q_per_kv 1 and 6, and
     at whisper-tiny's training shapes (B 8 x S 256 causal and not, B 8 x
     S 1,500 not causal; 6 heads of 64) and internvl2-2b's (B 4 x S 512,
     16 query over 8 KV heads of 128, causal), and in bfloat16 at
     qwen3-8b's group (B 2 x S 512, 32 query over 8 KV heads of 128,
     causal: q_per_kv 4), the
     scan at S 37 and 300 and from an initial state, at zamba2's 80 heads
     over B 1 x S 1,024 (8 cluster ranks of two chunks) and under strong
     decays at B 2 x S 256 (autograd then through the plain forward at
     4-row chunks, which at 64 rows lies 1e-4 of a gradient's scale off
     in float32); float32 within 2e-5
     and bfloat16 within 2e-2 of each gradient's largest magnitude, each
     backward twice, bitwise equal; an initial_state that requires a
     gradient raises;
  3. each kernel's time at the serving shapes of qwen3-8b and qwen2-1.5b
     (CUDA events, median of 21 runs, L2 flushed before each by reading a
     256 MB buffer), beside its bound, its plain version's time and
     scaled_dot_product_attention as a yardstick (over the gathered KV for
     the paged kernels, dequantized for the `_quant` ones over an int8 pool,
     with a length mask over the cache for the dense decode, causal for
     flash); the three decode kernels at B 8 x 512 keys, at phase 6's
     decode batch (4 of 8 slots live at 272 keys) and at B 8 x 1,024 keys,
     each also under the older write flush; the SSD scan at zamba2's
     prefill shapes (1 x 256 and 1 x 1024 tokens; no single PyTorch call
     computes it; bound by bytes or by flops at the 3xTF32 rate, the
     scalar float32 bound logged beside it; the same call at R = 1, 2, 4
     and 8 cluster ranks) and RMSNorm over 1024 rows of qwen3-8b's and
     zamba2's widths, qwen3-8b's decode (8 x 4096) and q-norm (8192 x 128)
     rows
     beside `torch.nn.functional.rms_norm`; the flash kernel also at phase
     6's monolithic prefill (qwen3-8b, B 4, S 256) and at whisper-tiny's
     encoder (B 8 x S 1,500, not causal, beside SDPA without is_causal);
     the backward kernels at
     the training shapes: #7b at qwen2-1.5b's B 8, S 256, internvl2-2b's
     B 4, S 512, zamba2's B 2, S 256 and whisper-tiny's B 8 x S 256 and
     1,500 (not causal) beside SDPA's backward (its forward and backward
     less its forward), #10b over qwen2-1.5b's 2,048 rows of 1,536,
     zamba2's 512 of 2,560 and internvl2-2b's 2,048 of 2,048 beside
     `F.rms_norm`'s backward, #9b at zamba2's B 2, S 256 (no library
     call; bound by bytes or by flops at the 3xTF32 rate, the scalar
     float32 bound logged beside it);
  4. the TINY test config through the port's dense, monolithic paged and
     chunked paged engines on the card and on the CPU: greedy tokens
     equal, logprobs within rtol 1e-4, atol 1e-5; dense and monolithic
     paged give the same tokens on the card; then the paged engines over
     int8 and fp8 pools, logprobs within atol 1e-2 (a float-noise rounding
     flip in a requantized page moves a value by a whole quantization
     step); then TINY_EDGE_C, xlstm-1.3b cut to 4 layers (sLSTM, mLSTM,
     sLSTM, mLSTM, chunks of 16) and zamba2 cut to 4 layers (float32) on
     the dense and paged engines at the first tolerance, a fan-out whose
     late forks must match its early ones, and the 4-layer zamba2 over an
     int8 pool; then TINY_CLOUD on chunked paged engines whose pool (6 pages
     of 8) cannot hold its 4 requests, resumed by host swap, by replay and
     under the serial scheduler, at the first tolerance (every engine must
     evict; swap-outs = swap-ins on the swapping ones); then, at the
     first tolerance and the configs' own capacity factor 1.25 (so MoE
     assignments drop), qwen3-moe-30b-a3b.reduced() and a top-8 variant
     on the dense, monolithic paged and chunked paged engines,
     mixtral-8x7b.reduced(sliding_window=64) on the dense engine with
     prompts padded past the window, and granite-3-8b.reduced() and
     minitron-8b.reduced() on the chunked paged engine; then
     whisper-tiny.reduced() (64 stub frames) and internvl2-2b.reduced() (16
     stub patch embeddings), float32: `encode`, `forward`, dense prefill of
     prompts of 12 and 37 padded to 64 and 8 greedy decode steps through
     the step builders (tokens equal, the first tolerance), and 3 train
     steps with the stub inputs at phase 11's gates;
  5. at full width — qwen3-8b in the cloud, the JAX package's edge fleet
     (qwen2-1.5b, xlstm-1.3b at 48 layers and zamba2-2.7b), random bf16
     weights from a seed: the PICE pipeline on paged engines (chunked for
     the attention stacks; zamba2 and xlstm-1.3b prefill monolithically,
     and the ensemble holds every edge, so each expands every progressive
     request; three corpus requests, and one more with the scheduler's
     decision pinned to progressive if none of them went progressive),
     the same on chunked paged engines over int8 pools (qwen3-8b,
     qwen2-1.5b), the same pipeline on dense engines over the same weight
     tensors (two requests), one 256-token xlstm-1.3b prefill timed, one
     batch each on monolithic paged qwen3-8b engines over a bf16 and an
     fp8 pool and on the paged zamba2 and xlstm-1.3b engines, the int8
     pool's KV read bytes against the bf16 pool's on one batch, and
     `score()` of a 1024-token sequence on each model, timed; each
     model's parameters counted in its tensors beside `param_count()`,
     its recurrent state bytes and the peak memory; every kernel's launch
     counter is set to 0 just before each of these paths and read just
     after: RMSNorm runs on every path (97 launches an xlstm-1.3b model
     call), and the flash kernel once an attention layer for each
     monolithic prefill;
  6. where each full-width engine's time goes (chunked paged qwen3-8b over
     a bf16 and an int8 pool, qwen2-1.5b, dense qwen3-8b, paged zamba2,
     paged xlstm-1.3b over 64-token prompts):
     host wall time against device busy time by kernel (torch.profiler) on
     a short batch, the port's kernels' time by device function, and the
     host's cudaLaunchKernel calls per model call;
  7. eviction at full width on phase 5's qwen3-8b weights (chunked,
     page 32, 4 slots, bf16 and int8 pools): 4 requests of a 384-token
     prompt and 128 new tokens on a pool of 40 pages, resumed by host swap
     and by replay, against a roomy pool, and the serial scheduler on the
     roomy pool (2 requests, 32 new tokens); every promote's pages read
     back and held byte for byte to the host snapshot; launches counted a
     run;
  8. swap against replay on the card's clock (qwen3-8b, bf16 and int8): a
     256-token prompt evicted after 64, 256 and 768 generated tokens, the
     demote, the promote and the resume to the next token by each way, the
     bytes, the host-link rates and the crossover;
  9. the load generator: one seeded trace of 16 requests through
     `replay_sync` on `EngineFrontend` over the 40-page qwen3-8b pool, with
     host swap and with replay: goodput, SLA attainment by tier, TTFT p50 /
     p99, and every handle final with no page left in use;
  10. warmed engines against cold ones (phase 6's, over the same weight
     tensors: chunked paged qwen3-8b over bf16 and int8 pools, qwen2-1.5b,
     monolithic paged zamba2-2.7b and xlstm-1.3b): `warmup()`'s seconds,
     dispatches, captured decode and ingest graphs and reserved memory;
     phase 6's batch must give the same greedy tokens, logprobs and
     launches of every wrapper warmed as cold, every warmed decode step and
     batched ragged ingest a graph replay (none dispatched eagerly), and a
     sampled pair
     from one seed the same tokens; a decode-only step's host wall time
     cold and warmed; one ingest call of 1 and 4 rows eager (cold) and
     replayed (warmed), qwen3-8b and qwen2-1.5b, its host wall to its
     return and to the device's end; the warmed run profiled as in phase 6,
     wall, device busy, busy share and launch calls a model call logged
     cold against warmed;
  11. training (float32 masters, the backward kernels): TINY_EDGE_A,
     TINY_CLOUD, TINY_EDGE_C, xlstm-1.3b and zamba2 cut to 4 layers, 3
     AdamW steps each on the card and on the CPU from the same masters and
     batches (losses within rtol 1e-4; every param within 3 lr, all but
     0.1 % within 1e-4); the 4-layer zamba2 run again on the card, bitwise
     equal; at full width qwen2-1.5b (bf16 compute, remat) 5 steps of B 8
     x S 256, whose loss must fall, and zamba2-2.7b 2 steps of B 2 x S
     256, whose loss on its first batch must fall, each step's loss, grad
     norm, wall and launches of every forward and backward wrapper logged
     with the peak memory, and one profiled step's device time by kind (a
     bf16 step must run the tensor-core #7b and the row #10b kernels and
     none of the float32 routes' scalar ones; zamba2's must run #9b's
     `ssd_bwd_mma` and `ssd_bwd_sum`); then the launcher:
     `build_engines(train_steps=150)` on the TINY fleet, each model's loss
     on a fixed batch before and after (it must fall), and the mean
     ROUGE-1 F1 of the trained fleet's pipeline beside the untrained one's
     over 4 corpus requests;
  12. the other families at full width, random bf16 weights, one model
     on the card at a time, launch counters set to 0 before each path:
     granite-3-8b and minitron-8b on chunked paged engines (page 32, 8
     slots, max_len 1,024), cold and warmed, phase 6's batch (4 x 256-token
     prompts, 32 new tokens): tokens/s, the decode step cold and warmed,
     finite logits, the unembedding's device time, peak memory;
     qwen3-moe-30b-a3b at full depth on chunked paged engines over a bf16
     and an int8 pool, the same batch cold and warmed, its dropped
     assignments, the experts a decode step routes against the expert
     bytes it reads, one MoE layer's device time split into router and
     top-k, dispatch, expert products and combine (CUDA events),
     `score()` of 1,024 tokens, peak memory; mixtral-8x7b cut to 16 of its
     32 layers on the dense engine (max_len 8,192): one 4,200-token prompt
     (bucket 8,192, past the 4,096 window) and 64 new tokens at capacity
     factor 8.0, each token's logprob within MIXTRAL_LOGPROB_ATOL of
     teacher-forced `forward`, then phase 6's batch at its own 1.25 with
     its drops; the reduced qwen3-moe and mixtral configs trained 3 steps
     card against CPU at phase 11's gates, the aux term logged;
  13. the encoder-decoder and VLM families at full width, random bf16
     weights and stub inputs from a seed, one model on the card at a time:
     whisper-tiny (its encoder over 8 x 1,500 frames, wall and flash
     launches; prompts of 4-32 tokens padded to 32 and 64 greedy decode
     steps over the dense cache through the step builders, each logprob
     within STUB_LOGPROB_ATOL of teacher-forced `forward` on the same
     frames; the 4 cached cross-attentions' share of a decode step's device
     time; 3 training steps of B 8 x S 256 with frames, the encoder's
     flash backward launches, none causal); internvl2-2b (dense prefill of
     8 rows of 256 patch embeddings and the same prompts, 32 greedy decode
     steps held to `forward` the same way; phase 6's batch text-only on
     chunked paged engines, cold and warmed; 2 training steps of B 4 x (256
     patches + 256 tokens), the loss dropping the patch positions; peak
     memory);
  14. the §IV-D fine-tuning pipeline: on TINY_CLOUD in float32, SFT and
     the reward model 20 steps each on the card and on the CPU from the
     same masters (logged losses within rtol 1e-4), `label_pair` on 8
     corpus examples through an SFT engine, RLAIF 3 steps at batch 2 twice
     on the card (equal histories, step 1's KL 0, the SFT params
     unchanged); then on qwen2-1.5b at full width (float32 masters, bf16
     compute): 2 SFT steps of 8 x 192, 2 reward-model steps of 8 x 160, 1
     RLAIF step at batch 2 with 64-token sketches, each part's wall,
     launches and peak memory;
  15. the dry-run's roofline against the card: qwen3-8b, zamba2-2.7b and
     qwen2-1.5b at long_500k (B 1 against 524,288 positions; the dense
     stacks a ring of 4,096) through `launch/dryrun.py` on the host (the
     step under fake tensors on the plain path: counted flops, bytes,
     peak), then the same decode step on the card at full width with
     random bf16 weights: the median step time, its share of the roofline
     (the larger of the flops and the unique-byte bound), the estimated
     peak memory against the measured one (not below it by more than
     10 %), the launches of #8 and #10;
  16. one JSON line of the kernels (with their launches on the paths of
     phases 7 and 9 under "eviction_paths" and of phases 12-15 under
     "family_paths"; the backward kernels' from phase 11's full-width
     training), the card's name and power limit, and the final {"ok":
     true, ...} line.

Each phase logs the seconds it took.

It raises on the first failure and prints the final line only when every
phase passed. It needs one CUDA card and the repository's `src/`.
"""
from __future__ import annotations

import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
# float32-accurate products on the TF32 tensor cores: 3xTF32 issues three
# TF32 MMAs (hi.hi, hi.lo, lo.hi) for each product, so a third of the
# 495 TFLOP/s dense TF32 rate (the SSD scan kernel, csrc/ssm_scan.cu)
TF32X3_FLOPS_PER_S = 495e12 / 3
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_kernels.py, SSD scan


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def chained_table(torch, lens, page, P, start=0):
    """Disjoint page chains covering each row's length; tail stays -1."""
    tbl = torch.full((len(lens), P), -1, dtype=torch.int32)
    nxt = start
    for b, ln in enumerate(lens):
        live = -(-int(ln) // page)
        tbl[b, :live] = torch.arange(nxt, nxt + live, dtype=torch.int32)
        nxt += live
    return tbl.cuda()


def pools(torch, gen, n_pages, page, Hkv, hd, dtype):
    shape = (n_pages, page, Hkv, hd)
    return (torch.randn(shape, generator=gen, device="cuda").to(dtype),
            torch.randn(shape, generator=gen, device="cuda").to(dtype))


def decode_case(torch, gen, B, Hq, Hkv, hd, page, P, dtype, lens=None,
                n_pages=None):
    q = torch.randn(B, 1, Hq, hd, generator=gen, device="cuda").to(dtype)
    if lens is None:
        lens = torch.randint(1, P * page + 1, (B,), generator=gen,
                             device="cuda").cpu()
        lens[0] = 0                                  # a length-0 slot
        lens[-1] = page + page // 2 if P > 1 else page // 2
    table = chained_table(torch, lens, page, P)
    kp, vp = pools(torch, gen, n_pages or B * P + 2, page, Hkv, hd, dtype)
    lens = torch.as_tensor(lens, dtype=torch.int32).cuda()
    return q, kp, vp, table, lens


def prefill_case(torch, gen, Hq, Hkv, hd, page, C, dtype, offs=None,
                 lens=None, share=True, n_pages=None):
    if offs is None:
        # a mid-prompt chunk, a first chunk, a short tail chunk, padding
        offs, lens = [C, 0, page + 3, 0], [C, C // 2, 5, 0]
    offs = torch.tensor(offs, dtype=torch.int32)
    lens = torch.tensor(lens, dtype=torch.int32)
    P = -(-int((offs + lens).max()) // page) + 1
    table = chained_table(torch, (offs + lens).tolist(), page, P)
    if share and len(offs) > 1 and table[0, 1] >= 0:
        table[1, :2] = table[0, :2]                  # COW-shared prefix pages
    kp, vp = pools(torch, gen, n_pages or int(table.max()) + 3, page, Hkv,
                   hd, dtype)
    q = torch.randn(len(offs), C, Hq, hd, generator=gen,
                    device="cuda").to(dtype)
    return q, kp, vp, table, offs.cuda(), lens.cuda()


def poisoned_cache(torch, gen, B, S, Hkv, hd, dtype, lens):
    """(k, v) dense caches with NaN at every position past each length."""
    k = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dtype)
    past = (torch.arange(S, device="cuda")[None, :]
            >= lens[:, None])[:, :, None, None]
    return (k.masked_fill(past, float("nan")),
            v.masked_fill(past, float("nan")))


def valid_rows(torch, out, lens):
    """Rows c < lens[r] of (R, C, ...) outputs: the rest are unspecified."""
    C = out.shape[1]
    m = torch.arange(C, device=out.device)[None, :] < lens[:, None]
    return out.float()[m]


def quant_pools(torch, gen, n_pages, page, Hkv, hd, kv_dtype):
    """(k_pages, v_pages, k_scales, v_scales): random pools quantized per
    (page, kv head) as the engine's writers quantize them."""
    from repro_torch.models import paged_cache as pc
    out = []
    for _ in range(2):
        f = torch.randn(n_pages, page, Hkv, hd, generator=gen, device="cuda")
        scale = pc.quant_scale(f.abs().amax(dim=(1, 3)), kv_dtype)
        out.append((pc._quantize(f, scale, kv_dtype), scale))
    (kp, ks), (vp, vs) = out
    return kp, vp, ks, vs


def poison_past(torch, pools, table, lens, page):
    """Store NaN (float32, bf16, fp8) or the extreme value (int8) at every
    position of each row's last mapped page past its length."""
    for p in pools:
        raw = p.view(torch.uint8)
        for b, ln in enumerate(lens):
            ln = int(ln)
            if not ln % page:
                continue
            if p.dtype in (torch.float32, torch.bfloat16):
                p[int(table[b, ln // page]), ln % page:] = float("nan")
            else:
                raw[int(table[b, ln // page]), ln % page:] = 0x7F


def mma_grid_blocks(q, k_pages, R):
    """Blocks of the tensor-core prefill kernel's grid: 64-row blocks of
    one kv head's query heads (64 at most) at 64 / heads chunk positions.
    Below the card's SM count a block takes two key groups."""
    C, Hq, Hkv = q.shape[1], q.shape[2], k_pages.shape[2]
    rep = Hq // Hkv
    hb = min(rep, 64)
    return R * Hkv * -(-rep // hb) * -(-C // (64 // hb))


def prefill_mma_cases(torch, gen):
    """The tensor-core prefill kernel (a bfloat16 query over a bf16, int8 or
    fp8 pool) at its edges, through the wrappers, against the plain
    versions at BF16_TOL: page 12 (not a multiple of 8) and 64, head_dim 24
    / 36 (8-byte copies of bf16 rows) / 80 / 256 (zero-padded 16-wide
    steps), q_per_kv 1, 4, 6, 16 and 72 (a GQA group split over blocks),
    chunks of 37 and 40 (no multiple of 16), rows that start mid-page, a
    padding row (lens 0, all pages -1) and -1 tail pages, NaN (bf16, fp8)
    or 127 (int8) stored past each length. qwen3-8b's heads at R = 4 give a
    grid of at least the SM count (one key group a block), every other
    case a smaller one (two key groups): both paths are checked."""
    from repro_torch.kernels.paged_prefill_attention import ops as pops
    from repro_torch.kernels.paged_prefill_attention import ref as pref
    bf16 = torch.bfloat16
    n = 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    key_groups = {1: 0, 2: 0}          # cases by key groups a block
    # (Hq, Hkv, hd, page, C): q_per_kv 4, 1, 6, 16, 16, 1, 72, 4
    shapes = [(8, 2, 32, 12, 37), (6, 6, 80, 64, 48), (12, 2, 24, 12, 64),
              (32, 2, 256, 16, 40), (16, 1, 64, 64, 128),
              (8, 8, 36, 12, 37), (72, 1, 32, 12, 37),
              (32, 8, 128, 32, 128)]
    for kv_dtype in ("bf16", "int8", "fp8"):
        quant = kv_dtype != "bf16"
        for Hq, Hkv, hd, page, C in shapes:
            if quant and hd % 8:
                continue            # int8 / fp8 rows are read in 8 bytes
            for offs, lens in ((None, None), ([C + 5], [C])):
                q, kp, vp, rows, ot, lt = prefill_case(
                    torch, gen, Hq, Hkv, hd, page, C, bf16, offs, lens)
                pools = (quant_pools(torch, gen, kp.shape[0], page, Hkv, hd,
                                     kv_dtype) if quant else (kp, vp))
                # row 1 shares row 0's first pages: poison rows 0 and 2
                live = [0, 2] if len(ot) > 1 else [0]
                poison_past(torch, pools[:2], rows.cpu()[live],
                            (ot + lt).cpu()[live], page)
                if len(ot) > 1:
                    fn = (pops.paged_prefill_attention_ragged_quant if quant
                          else pops.paged_prefill_attention_ragged)
                    plain = (pref.paged_prefill_attention_ragged_quant_ref
                             if quant else
                             pref.paged_prefill_attention_ragged_ref)
                    got = fn(q, *pools, rows, ot, lt)
                else:
                    fn = (pops.paged_prefill_attention_quant if quant
                          else pops.paged_prefill_attention)
                    plain = (pref.paged_prefill_attention_quant_ref if quant
                             else pref.paged_prefill_attention_ref)
                    got = fn(q, *pools, rows[0], ot, lt)
                want = plain(q, *pools, rows if len(ot) > 1 else rows[0],
                             ot, lt)
                torch.cuda.synchronize()
                dead = torch.arange(C, device="cuda")[None, :] >= lt[:, None]
                assert torch.isfinite(got).all(), \
                    "NaN past a length reached out"
                assert torch.all(got[dead] == 0), \
                    "rows past a length must be zeros"
                torch.testing.assert_close(valid_rows(torch, got, lt),
                                           valid_rows(torch, want, lt),
                                           **BF16_TOL)
                key_groups[1 if mma_grid_blocks(q, kp, len(ot)) >= sms
                           else 2] += 1
                n += 1
    assert key_groups[1] and key_groups[2], key_groups
    log(f"tensor-core prefill cases by key groups a block: {key_groups}")
    return n


def decode_mma_cases(torch, gen):
    """The tensor-core decode kernel (a bfloat16 query over bf16, int8 and
    fp8 pools, #1 / #4; over a bf16 dense cache, #8) at its edges, through
    the wrappers, against the plain versions at BF16_TOL: q_per_kv 1, 2, 4,
    6, 16 and 24 (two 16-head row tiles), head_dim 16 / 24 / 36 (8-byte
    copies of bf16 rows) / 80 / 128 / 256, pages of 8, 12, 32 and 64,
    splits of 1 and at the cluster cap, one slot of 4,096 keys (more tiles
    than the ring holds), a zero-length slot, -1 tail pages, NaN (bf16,
    fp8) or 127 (int8) stored past each length, COW-shared pages; the dense
    kernel over a slice of a larger cache with S no tile divides and over
    4,096 rows."""
    from repro_torch.kernels.decode_attention import kernel as ddk
    from repro_torch.kernels.decode_attention import ops as ddops
    from repro_torch.kernels.decode_attention import ref as ddref
    from repro_torch.kernels.paged_decode_attention import kernel as dk
    from repro_torch.kernels.paged_decode_attention import ops as dops
    from repro_torch.kernels.paged_decode_attention import ref as dref
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits_seen = set()
    n = 0
    # (B, Hq, Hkv, hd, page, P): q_per_kv 1, 2, 4, 6, 16, 24, 4, 1
    shapes = [(3, 4, 4, 24, 8, 6), (2, 4, 2, 16, 12, 9),
              (66, 32, 8, 128, 32, 3), (4, 12, 2, 80, 64, 3),
              (2, 16, 1, 256, 16, 8), (2, 24, 1, 36, 12, 10),
              (1, 32, 8, 128, 64, 64), (8, 32, 32, 80, 32, 6)]
    for kv_dtype in ("bf16", "int8", "fp8"):
        quant = kv_dtype != "bf16"
        for B, Hq, Hkv, hd, page, P in shapes:
            if quant and hd % 8:
                continue            # int8 / fp8 rows are read in 8 bytes
            lens = [P * page] if B == 1 else None    # 4,096 keys at B = 1
            q, kp, vp, tbl, ln = decode_case(torch, gen, B, Hq, Hkv, hd,
                                             page, P, bf16, lens=lens)
            kv = (quant_pools(torch, gen, kp.shape[0], page, Hkv, hd,
                              kv_dtype) if quant else (kp, vp))
            poison_past(torch, kv[:2], tbl.cpu(), ln.cpu(), page)
            fn = (dops.paged_decode_attention_quant if quant
                  else dops.paged_decode_attention)
            plain = (dref.paged_decode_attention_quant_ref if quant
                     else dref.paged_decode_attention_ref)
            got = fn(q, *kv, tbl, ln)
            torch.cuda.synchronize()
            want = plain(q, *kv, tbl, ln)
            assert torch.isfinite(got).all(), "NaN past a length reached out"
            if B > 1:
                assert torch.all(got[0] == 0), "a zero-length slot gives 0"
            torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
            splits_seen.add(dk.split_pages(B, Hkv, P, sms)[0])
            n += 1
        # COW fan-out: rows share prefix pages (pages of 12)
        q = torch.randn(2, 1, 12, 32, generator=gen, device="cuda").to(bf16)
        kv = (quant_pools(torch, gen, 12, 12, 2, 32, kv_dtype) if quant
              else pools(torch, gen, 12, 12, 2, 32, bf16))
        tbl = torch.tensor([[0, 1, 2, -1], [0, 1, 3, 4]], dtype=torch.int32,
                           device="cuda")
        ln = torch.tensor([30, 45], dtype=torch.int32, device="cuda")
        fn = (dops.paged_decode_attention_quant if quant
              else dops.paged_decode_attention)
        plain = (dref.paged_decode_attention_quant_ref if quant
                 else dref.paged_decode_attention_ref)
        got = fn(q, *kv, tbl, ln)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(),
                                   plain(q, *kv, tbl, ln).float(),
                                   **BF16_TOL)
        n += 1
    assert {1, dk.MAX_SPLITS} <= splits_seen, splits_seen
    # the dense kernel over a slice of a larger cache (row offset 3, S =
    # 200), and over 4,096 rows; NaN past each length
    for (B, S, Hq, Hkv, hd), view in (((4, 400, 12, 2, 128), True),
                                      ((1, 4096, 32, 8, 128), False)):
        lens = torch.randint(1, 201, (B,), generator=gen,
                             device="cuda").to(torch.int32)
        if view:
            lens[0] = 0
        else:
            lens[:] = S
        k, v = poisoned_cache(torch, gen, B, S, Hkv, hd, bf16,
                              lens + (3 if view else 0))
        q = torch.randn(B, 1, Hq, hd, generator=gen, device="cuda").to(bf16)
        if view:
            k, v = k[:, 3:203], v[:, 3:203]
        got = ddops.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), "NaN past a length reached out"
        torch.testing.assert_close(
            got.float(), ddref.decode_attention_ref(q, k, v, lens).float(),
            **BF16_TOL)
        splits_seen.add(ddk.split_rows(B, Hkv, k.shape[1], sms)[0])
        n += 1
    log(f"tensor-core decode cases by splits a (slot, kv head): "
        f"{sorted(splits_seen)}")
    return n


def quant_kernel_cases(torch, gen, dtype, tol):
    """#4-#6 against their plain versions over int8 and fp8 pools: the
    paged kernels' case families, head_dim 16/24/32/128, q_per_kv
    1/2/4/6, page 8/16/32, NaN (fp8) or 127 (int8) past each length."""
    from repro_torch.kernels.paged_decode_attention import ops as dops
    from repro_torch.kernels.paged_decode_attention import ref as dref
    from repro_torch.kernels.paged_prefill_attention import ops as pops
    from repro_torch.kernels.paged_prefill_attention import ref as pref
    n = 0
    for kv_dtype in ("int8", "fp8"):
        # (B, Hq, Hkv, hd, page, P): q_per_kv 4, 1, 6, 2, 4, 6
        for B, Hq, Hkv, hd, page, P in [
                (3, 8, 2, 32, 8, 6), (2, 4, 4, 24, 16, 4),
                (4, 12, 2, 128, 32, 8), (3, 8, 4, 16, 16, 5),
                (8, 32, 8, 128, 32, 16), (66, 12, 2, 128, 8, 3),
                (4, 32, 32, 80, 32, 4)]:
            q, _, _, tbl, lens = decode_case(torch, gen, B, Hq, Hkv, hd, page,
                                             P, dtype, n_pages=1)
            pools = quant_pools(torch, gen, B * P + 2, page, Hkv, hd,
                                kv_dtype)
            poison_past(torch, pools[:2], tbl.cpu(), lens.cpu(), page)
            got = dops.paged_decode_attention_quant(q, *pools, tbl, lens)
            torch.cuda.synchronize()
            want = dref.paged_decode_attention_quant_ref(q, *pools, tbl, lens)
            assert torch.isfinite(got).all(), "NaN past a length reached out"
            assert torch.all(got[0] == 0), "a zero-length slot must give 0"
            torch.testing.assert_close(got.float(), want.float(), **tol)
            n += 1
        # COW fan-out: rows share prefix pages
        q = torch.randn(2, 1, 8, 32, generator=gen, device="cuda").to(dtype)
        pools = quant_pools(torch, gen, 12, 8, 2, 32, kv_dtype)
        tbl = torch.tensor([[0, 1, 2, -1], [0, 1, 3, 4]], dtype=torch.int32,
                           device="cuda")
        lens = torch.tensor([20, 28], dtype=torch.int32, device="cuda")
        got = dops.paged_decode_attention_quant(q, *pools, tbl, lens)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got.float(), dref.paged_decode_attention_quant_ref(
                q, *pools, tbl, lens).float(), **tol)
        n += 1
        # (Hq, Hkv, hd, page, C): a mid-prompt chunk, a first chunk, a
        # tail chunk starting mid-page, padding; COW-shared prefix pages
        for Hq, Hkv, hd, page, C in [(8, 2, 32, 8, 16), (4, 4, 24, 16, 48),
                                     (12, 2, 128, 32, 64),
                                     (6, 2, 16, 16, 128),
                                     (32, 8, 128, 32, 128)]:
            q, _, _, rows, offs, lens = prefill_case(torch, gen, Hq, Hkv, hd,
                                                     page, C, dtype,
                                                     n_pages=1)
            pools = quant_pools(torch, gen, int(rows.max()) + 3, page, Hkv,
                                hd, kv_dtype)
            # row 1 shares row 0's first pages: poison rows 0 and 2 only
            poison_past(torch, pools[:2], rows.cpu()[[0, 2]],
                        (offs + lens).cpu()[[0, 2]], page)
            got = pops.paged_prefill_attention_ragged_quant(q, *pools, rows,
                                                            offs, lens)
            torch.cuda.synchronize()
            want = pref.paged_prefill_attention_ragged_quant_ref(
                q, *pools, rows, offs, lens)
            assert torch.isfinite(valid_rows(torch, got, lens)).all()
            torch.testing.assert_close(valid_rows(torch, got, lens),
                                       valid_rows(torch, want, lens), **tol)
            n += 1
        for (Hq, Hkv, hd, page, C), (off, ln) in [
                ((8, 2, 32, 8, 16), (0, 16)), ((8, 2, 32, 8, 16), (21, 9)),
                ((12, 2, 128, 32, 128), (256, 128)),
                ((4, 4, 24, 16, 48), (40, 1))]:
            q, _, _, rows, offs, lens = prefill_case(
                torch, gen, Hq, Hkv, hd, page, C, dtype, [off], [ln],
                n_pages=1)
            pools = quant_pools(torch, gen, int(rows.max()) + 3, page, Hkv,
                                hd, kv_dtype)
            poison_past(torch, pools[:2], rows.cpu(), [off + ln], page)
            got = pops.paged_prefill_attention_quant(q, *pools, rows[0], off,
                                                     ln)
            torch.cuda.synchronize()
            want = pref.paged_prefill_attention_quant_ref(
                q, *pools, rows[0], offs, lens)
            torch.testing.assert_close(valid_rows(torch, got, lens),
                                       valid_rows(torch, want, lens), **tol)
            n += 1
    return n


def mixed_pool_cases(torch, gen):
    """#1-#3 over a bf16 pool under a float32 query (kv_dtype="bfloat16"
    with float32 compute), at the float32 tolerance: both sides compute in
    f32 from the same bf16 values."""
    from repro_torch.kernels.paged_decode_attention import ops as dops
    from repro_torch.kernels.paged_decode_attention import ref as dref
    from repro_torch.kernels.paged_prefill_attention import ops as pops
    from repro_torch.kernels.paged_prefill_attention import ref as pref
    f32, bf16 = torch.float32, torch.bfloat16
    n = 0
    for shape in [(3, 8, 2, 32, 8, 6), (4, 12, 2, 128, 32, 8)]:
        q, kp, vp, tbl, lens = decode_case(torch, gen, *shape, f32)
        kp, vp = kp.to(bf16), vp.to(bf16)
        got = dops.paged_decode_attention(q, kp, vp, tbl, lens)
        torch.cuda.synchronize()
        assert got.dtype == f32
        torch.testing.assert_close(
            got, dref.paged_decode_attention_ref(q, kp, vp, tbl, lens),
            **F32_TOL)
        n += 1
    for shape in [(8, 2, 32, 8, 16), (12, 2, 128, 32, 64)]:
        q, kp, vp, rows, offs, lens = prefill_case(torch, gen, *shape, f32)
        kp, vp = kp.to(bf16), vp.to(bf16)
        got = pops.paged_prefill_attention_ragged(q, kp, vp, rows, offs,
                                                  lens)
        one = pops.paged_prefill_attention(q[:1], kp, vp, rows[0],
                                           offs[:1], lens[:1])
        torch.cuda.synchronize()
        want = pref.paged_prefill_attention_ragged_ref(q, kp, vp, rows, offs,
                                                       lens)
        torch.testing.assert_close(valid_rows(torch, got, lens),
                                   valid_rows(torch, want, lens), **F32_TOL)
        torch.testing.assert_close(valid_rows(torch, one, lens[:1]),
                                   valid_rows(torch, want[:1], lens[:1]),
                                   **F32_TOL)
        n += 2
    return n


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import runtime
    t0 = time.perf_counter()
    runtime.build_all()
    build_s = time.perf_counter() - t0
    log("== phase 1: environment")
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    log(f"kernel build: {build_s:.1f} s for {', '.join(runtime.KERNELS)}")
    resource_report(runtime.resource_usage())
    log(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def demangled(names):
    """{mangled: readable} through c++filt where the machine has it (the
    mangled name itself where it does not)."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    if len(out) != len(names):
        out = names
    return dict(zip(names, out))


def resource_report(rows):
    """Each kernel function's registers, spilled bytes and static shared
    memory as ptxas reported them at the build (the compiler's half of the
    static checker's RA4xx, `repro_torch.analysis.cuda_spec`): every
    function within sm_90's 255 registers a thread and 227 KB of shared
    memory a block, and every source reported. Spills are findings, not
    failures."""
    from repro_torch.analysis import rules
    from repro_torch.kernels import runtime
    assert {r["source"] for r in rows} == set(runtime.KERNELS), \
        "a kernel source has no build log: its resources are not reported"
    names = demangled([r["function"] for r in rows])
    spills = 0
    for r in rows:
        log(f"  {r['source']}: {names[r['function']][:100]}: {r['registers']} "
            f"registers, {r['spill_stores']} / {r['spill_loads']} bytes "
            f"spilled (stores / loads), {r['smem']} B static shared memory")
        assert r["registers"] is not None \
            and r["registers"] <= rules.MAX_REGISTERS, r
        assert r["smem"] <= rules.SMEM_MAX_BYTES, r
        spills += r["spill_stores"] > 0
    log(f"resources: {len(rows)} kernel functions, at most "
        f"{max(r['registers'] for r in rows)} registers and "
        f"{max(r['smem'] for r in rows)} B of static shared memory; "
        f"{spills} spill")


def phase_kernels_vs_plain(torch):
    from repro_torch.kernels.paged_decode_attention import ops as dops
    from repro_torch.kernels.paged_decode_attention import ref as dref
    from repro_torch.kernels.paged_prefill_attention import ops as pops
    from repro_torch.kernels.paged_prefill_attention import ref as pref
    log("== phase 2: kernels against their plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n = 0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        # (B, Hq, Hkv, hd, page, P): q_per_kv 4, 1, 6, 2, 4, 4, 1, 16;
        # hd 32/24/128/64/256; one split per slot (66 x 8 rows fill the
        # card) up to one page per split
        for shape in [(3, 8, 2, 32, 8, 6), (2, 4, 4, 24, 16, 4),
                      (4, 12, 2, 128, 32, 8), (3, 8, 4, 32, 16, 5),
                      (8, 32, 8, 128, 32, 16), (2, 16, 4, 64, 32, 3),
                      (66, 8, 8, 32, 8, 3), (2, 32, 2, 256, 16, 4),
                      (8, 32, 32, 80, 32, 6)]:
            q, kp, vp, tbl, lens = decode_case(torch, gen, *shape, dtype)
            got = dops.paged_decode_attention(q, kp, vp, tbl, lens)
            torch.cuda.synchronize()
            want = dref.paged_decode_attention_ref(q, kp, vp, tbl, lens)
            torch.testing.assert_close(got.float(), want.float(), **tol)
            assert torch.all(got[0] == 0), "a zero-length slot must give 0"
            n += 1
        # COW fan-out: rows share prefix pages
        q, kp, vp, _, _ = decode_case(torch, gen, 2, 8, 2, 32, 8, 4, dtype,
                                      lens=[20, 28], n_pages=12)
        tbl = torch.tensor([[0, 1, 2, -1], [0, 1, 3, 4]], dtype=torch.int32,
                           device="cuda")
        lens = torch.tensor([20, 28], dtype=torch.int32, device="cuda")
        got = dops.paged_decode_attention(q, kp, vp, tbl, lens)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got.float(),
            dref.paged_decode_attention_ref(q, kp, vp, tbl, lens).float(),
            **tol)
        n += 1
        # (Hq, Hkv, hd, page, C): q_per_kv 4, 1, 6, 2, 4; C 16/48/64/128
        for shape in [(8, 2, 32, 8, 16), (4, 4, 24, 16, 48),
                      (12, 2, 128, 32, 64), (8, 4, 32, 16, 128),
                      (32, 8, 128, 32, 128)]:
            q, kp, vp, rows, offs, lens = prefill_case(torch, gen, *shape,
                                                       dtype)
            got = pops.paged_prefill_attention_ragged(q, kp, vp, rows, offs,
                                                      lens)
            torch.cuda.synchronize()
            want = pref.paged_prefill_attention_ragged_ref(q, kp, vp, rows,
                                                           offs, lens)
            torch.testing.assert_close(valid_rows(torch, got, lens),
                                       valid_rows(torch, want, lens), **tol)
            n += 1
        for (Hq, Hkv, hd, page, C), (off, ln) in [
                ((8, 2, 32, 8, 16), (0, 16)), ((8, 2, 32, 8, 16), (21, 9)),
                ((12, 2, 128, 32, 128), (256, 128)),
                ((4, 4, 24, 16, 48), (40, 1))]:
            q, kp, vp, rows, offs, lens = prefill_case(
                torch, gen, Hq, Hkv, hd, page, C, dtype, [off], [ln])
            got = pops.paged_prefill_attention(q, kp, vp, rows[0], off, ln)
            torch.cuda.synchronize()
            want = pref.paged_prefill_attention_ref(q, kp, vp, rows[0],
                                                    offs, lens)
            torch.testing.assert_close(valid_rows(torch, got, lens),
                                       valid_rows(torch, want, lens), **tol)
            n += 1
        if dtype == torch.bfloat16:
            nd = decode_mma_cases(torch, gen)
            log(f"{nd} cases of the tensor-core decode kernel (bf16 query "
                f"over bf16, int8 and fp8 pools and a bf16 dense cache) "
                f"passed")
            n += nd
            nm = prefill_mma_cases(torch, gen)
            log(f"{nm} cases of the tensor-core prefill kernel (bf16 query "
                f"over bf16, int8 and fp8 pools) passed")
            n += nm
            nf = flash_wgmma_cases(torch, gen)
            log(f"{nf} cases of the tensor-core flash kernel passed")
            n += nf
        n += dense_kernel_cases(torch, gen, dtype, tol)
        nr = ring_decode_cases(torch, gen, dtype, tol)
        log(f"{dtype} query: {nr} cases of the dense decode kernel over a "
            f"sliding-window ring (w = 64) passed")
        n += nr
        nq = quant_kernel_cases(torch, gen, dtype, tol)
        log(f"{dtype} query: {nq} cases of the _quant kernels over int8 and "
            f"fp8 pools passed")
        n += nq
    nm = mixed_pool_cases(torch, gen)
    log(f"{nm} cases of the float kernels over a bf16 pool under a float32 "
        f"query passed")
    n += nm
    log(f"{n} cases passed (float32 query at rtol=atol=2e-5, bfloat16 at "
        f"rtol=atol=2e-2)")
    ns, nr = ssm_scan_cases(torch, gen), rmsnorm_cases(torch, gen)
    log(f"{ns} cases of the SSD scan passed (rtol=atol=1e-4), {nr} of "
        f"RMSNorm (float32 at 2e-5, bfloat16 at 2e-2)")
    nb = backward_kernel_cases(torch, gen)
    log(f"{nb} cases of the backward kernels passed (float32 within 2e-5, "
        f"bfloat16 within 2e-2 of each gradient's largest magnitude)")


def scan_inputs(torch, gen, Bb, S, H, P, N, initial=False, strong=False):
    """tests/test_kernels.py's law: dt = softplus(randn) * 0.1, A =
    -exp(randn), B and C at 0.3 scale; float32 on the card. `strong`:
    strong decays instead, A uniform in [-80, -1] and dt in [0, 1]."""
    kw = dict(generator=gen, device="cuda")
    x = torch.randn(Bb, S, H, P, **kw)
    if strong:
        dt = torch.rand(Bb, S, H, **kw)
        A = -(1 + 79 * torch.rand(H, **kw))
    else:
        dt = torch.nn.functional.softplus(torch.randn(Bb, S, H, **kw)) * 0.1
        A = -torch.exp(torch.randn(H, **kw))
    B = torch.randn(Bb, S, N, **kw) * 0.3
    C = torch.randn(Bb, S, N, **kw) * 0.3
    h0 = torch.randn(Bb, H, P, N, **kw) if initial else None
    return x, dt, A, B, C, h0


def ssm_scan_cases(torch, gen):
    """#9 against its plain chunked version: the JAX kernel test's cases,
    ragged S (37, 1000; the plain chunk halves to 37 and to 8 rows),
    TINY_EDGE_C's heads (H 4, P 64, N 16, chunk 64), zamba2's (H 80, P 64,
    N 64, chunk 256) at S 1024, and initial states; then the edges of the
    cluster split (tests/test_torch_ssm_numerics.py's cases): S of 1, 63,
    65 and 129 (segment and chunk edges mid-tile), P 4 with N 8, an initial
    state crossing ranks, strong decays (A down to -80, dt up to 1; the
    plain version at 64-row chunks, as the kernel walks, since an exp of a
    difference of longer cumulative sums loses digits), a batch of 4 x 80
    heads that fills the card (R = 1, a segment of two super-chunks), and
    S of 1,500 and 2,048 (R = 8 with segments longer than a super-chunk:
    the walk for the segment's state, then the walk with the running
    state). Logs the planner's R for each case."""
    from repro_torch.kernels.ssm_scan import kernel as skernel
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    blocks = skernel.card_blocks(torch.device("cuda"))
    n, splits = 0, []
    for Bb, S, H, P, N, chunk, initial, strong in [
            (2, 64, 3, 8, 16, 16, False, False),
            (1, 128, 2, 16, 32, 32, False, False),
            (2, 96, 1, 4, 8, 32, False, False),
            (2, 37, 4, 64, 16, 64, False, False),
            (1, 1000, 4, 64, 16, 64, False, False),
            (3, 200, 4, 64, 16, 64, False, False),
            (1, 1024, 80, 64, 64, 256, False, False),
            (1, 256, 80, 64, 64, 256, True, False),
            (2, 100, 3, 8, 16, 32, True, False),
            (2, 1, 3, 16, 32, 64, False, False),
            (2, 63, 3, 16, 32, 64, False, False),
            (2, 65, 3, 16, 32, 64, False, False),
            (2, 129, 3, 16, 32, 64, False, False),
            (2, 300, 3, 4, 8, 64, False, False),
            (2, 300, 4, 16, 16, 64, True, False),
            (1, 512, 4, 32, 32, 64, True, True),
            (4, 256, 80, 64, 64, 256, True, False),
            (1, 1500, 8, 64, 64, 64, True, False),
            (1, 2048, 80, 64, 64, 256, True, False)]:
        x, dt, A, B, C, h0 = scan_inputs(torch, gen, Bb, S, H, P, N, initial,
                                         strong)
        y, h = sops.ssm_scan(x, dt, A, B, C, chunk=chunk, initial_state=h0)
        torch.cuda.synchronize()
        yr, hr = sref.ssd_chunked_ref(x, dt, A, B, C, chunk=chunk,
                                      initial_state=h0)
        assert torch.isfinite(y).all() and torch.isfinite(h).all()
        torch.testing.assert_close(y, yr, **SCAN_TOL)
        torch.testing.assert_close(h, hr, **SCAN_TOL)
        ranks, per = skernel.split_sequence(Bb, H, S, blocks)
        splits.append((ranks, per))
        err = max((y - yr).abs().max().item(), (h - hr).abs().max().item())
        log(f"  ssm_scan Bb={Bb} S={S} H={H} P={P} N={N} "
            f"{'h0 ' if initial else ''}{'strong ' if strong else ''}"
            f"R={ranks} chunks/rank={per}: max_abs_err {err:.3g}")
        n += 1
    assert (1, 4) in splits and any(r > 1 and per > skernel.KEEP_CHUNKS
                                    for r, per in splits), splits
    log(f"  the card holds {blocks} scan blocks at once")
    return n


def flash_launch_shape(torch, B, S, Hq, Hkv, hd):
    """(rows, key groups) of a block of the bf16 flash kernel's launch
    (`csrc/flash_attention.cu` launch_wgmma_shape): 128 rows where that
    grid has at least as many blocks as the card has SMs; else 64 rows with
    two key groups up to head_dim 192, one above."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rep = Hq // Hkv
    hb = min(rep, 128)
    if B * Hkv * -(-rep // hb) * -(-S // (128 // hb)) >= sms:
        return 128, 1
    return 64, (2 if hd <= 192 else 1)


def flash_wgmma_cases(torch, gen):
    """The tensor-core flash kernel (bf16) against its plain version at
    BF16_TOL: q_per_kv 1, 4, 6, 16 and 72 (a GQA group split over blocks),
    head_dim 64, 80, 128 and 256 (64-wide atoms, zero padded), S 1, 37,
    200 and 1000 (no multiple of a tile), causal and not, window 0 / 64,
    softcap 0 / 30. Every launch shape (128 rows; 64 rows with two key
    groups and with one) is among them."""
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention import ref as faref
    bf16 = torch.bfloat16
    shapes = {}
    n = 0
    # (Hq, Hkv, hd): q_per_kv 1, 4, 6, 16, 72, 1 (zamba2's heads)
    for Hq, Hkv, hd in [(8, 8, 64), (32, 8, 128), (12, 2, 128),
                        (32, 2, 256), (72, 1, 80), (32, 32, 80)]:
        for S in (1, 37, 200, 1000):
            B = 2 if S == 37 else 1
            q = torch.randn(B, S, Hq, hd, generator=gen,
                            device="cuda").to(bf16)
            k = torch.randn(B, S, Hkv, hd, generator=gen,
                            device="cuda").to(bf16)
            v = torch.randn(B, S, Hkv, hd, generator=gen,
                            device="cuda").to(bf16)
            shape = flash_launch_shape(torch, B, S, Hq, Hkv, hd)
            for causal, window, softcap in FLASH_MASKS:
                kw = dict(causal=causal, window=window, softcap=softcap)
                got = faops.flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                assert torch.isfinite(got).all()
                torch.testing.assert_close(
                    got.float(),
                    faref.flash_attention_ref(q, k, v, **kw).float(),
                    **BF16_TOL)
                shapes[shape] = shapes.get(shape, 0) + 1
                n += 1
    assert set(shapes) == {(128, 1), (64, 2), (64, 1)}, shapes
    log(f"tensor-core flash cases by (rows, key groups) a block: {shapes}")
    return n


# (causal, window, softcap) of the flash kernel's card cases
FLASH_MASKS = [(True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0),
               (False, 0, 0.0), (False, 64, 30.0), (True, 64, 30.0)]


def rmsnorm_cases(torch, gen):
    """#10 against its plain version: float32 and bfloat16, D from 96 to
    5120 (the served widths: 128 for q/k-norm, 1536, 2560, 4096 and 5120),
    row counts no block divides (1, 8, 256, 1027 and more)."""
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm import ref as rref
    n = 0
    widths = (128, 1536, 2560, 4096, 5120)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for R, D in [(3, 96), (1000, 128), (37, 1536), (64, 2560),
                     (5, 4096), (129, 5120)] + [
                (R, D) for R in (1, 8, 256, 1027) for D in widths]:
            x = torch.randn(R, D, generator=gen, device="cuda").to(dtype)
            scale = torch.randn(D, generator=gen, device="cuda")
            got = rops.rmsnorm(x, scale, 1e-6)
            torch.cuda.synchronize()
            assert got.dtype == dtype
            torch.testing.assert_close(
                got.float(), rref.rmsnorm_ref(x, scale, 1e-6).float(), **tol)
            n += 1
    return n


def dense_kernel_cases(torch, gen, dtype, tol):
    """The dense decode and flash kernels against their plain versions
    (tests/test_kernels.py's shapes, S no tile divides, head_dim 24/128,
    q_per_kv 1/2/4/6)."""
    from repro_torch.kernels.decode_attention import ops as ddops
    from repro_torch.kernels.decode_attention import ref as ddref
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention import ref as faref
    n = 0
    # (B, S, Hq, Hkv, hd): lengths from 1 to S, NaN past each, slot 0 empty
    for B, S, Hq, Hkv, hd in [(2, 128, 4, 2, 32), (3, 256, 8, 8, 64),
                              (2, 64, 16, 4, 128), (3, 300, 12, 2, 128),
                              (3, 200, 6, 1, 24), (8, 1024, 32, 8, 128),
                              (4, 300, 32, 32, 80)]:
        lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda")
        lens[0], lens[-1] = 0, S
        lens = lens.to(torch.int32)
        q = torch.randn(B, 1, Hq, hd, generator=gen, device="cuda").to(dtype)
        k, v = poisoned_cache(torch, gen, B, S, Hkv, hd, dtype, lens)
        got = ddops.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), "NaN past a length reached out"
        assert torch.all(got[0] == 0), "a zero-length slot must give 0"
        torch.testing.assert_close(
            got.float(), ddref.decode_attention_ref(q, k, v, lens).float(),
            **tol)
        n += 1
    # the engine's read: a view of the first live rows; lengths past it
    # (inactive slots) read all of it
    lens = torch.tensor([0, 5, 300, 301, 700], dtype=torch.int32,
                        device="cuda")
    q = torch.randn(5, 1, 32, 128, generator=gen, device="cuda").to(dtype)
    k, v = poisoned_cache(torch, gen, 5, 1024, 8, 128, dtype, lens)
    k, v = k[:, :301], v[:, :301]
    got = ddops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.all(got[0] == 0)
    torch.testing.assert_close(
        got.float(), ddref.decode_attention_ref(q, k, v, lens).float(), **tol)
    n += 1
    # (B, S, Hq, Hkv, hd) x (causal, window, softcap)
    for B, S, Hq, Hkv, hd in [(2, 128, 4, 2, 32), (1, 256, 8, 8, 64),
                              (2, 64, 4, 1, 16), (1, 512, 2, 2, 128),
                              (1, 200, 12, 2, 128), (2, 300, 6, 1, 24),
                              (1, 256, 32, 32, 80)]:
        q = torch.randn(B, S, Hq, hd, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dtype)
        for causal, window, softcap in [(True, 0, 0.0), (True, 64, 0.0),
                                        (True, 0, 30.0), (False, 0, 0.0),
                                        (False, 64, 30.0)]:
            kw = dict(causal=causal, window=window, softcap=softcap)
            got = faops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                got.float(), faref.flash_attention_ref(q, k, v, **kw).float(),
                **tol)
            n += 1
    # whisper-tiny: its encoder over 1,500 frames (no tile divides it), not
    # causal, at B 1 and 8; its decoder's causal prefill at S 256; 6 heads
    # of 64 at q_per_kv 1. internvl2-2b: phase 13's prefill (256 patches +
    # 32 tokens), 16 query heads over 8 KV heads of 128, causal
    for B, S, Hq, Hkv, hd, causal in ((8, 1500, 6, 6, 64, False),
                                      (1, 1500, 6, 6, 64, False),
                                      (8, 256, 6, 6, 64, True),
                                      (8, 288, 16, 8, 128, True)):
        q = torch.randn(B, S, Hq, hd, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(B, S, Hkv, hd, generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        got = faops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got.float(),
            faref.flash_attention_ref(q, k, v, causal=causal).float(), **tol)
        if dtype == torch.bfloat16:
            log(f"flash B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} "
                f"causal={causal}: launch shape "
                f"{flash_launch_shape(torch, B, S, Hq, Hkv, hd)}")
        n += 1
    return n


def ring_decode_cases(torch, gen, dtype, tol):
    """The dense decode kernel (#8) over a sliding-window ring laid out as
    the port's prefill lays it (`cache.ring_positions`: each slot's last w
    positions, position p in row p % w; rows no position reached hold NaN)
    at w = 64, totals short of, at and past the window, read over
    min(total, w) rows; against the JAX package's plain ring mask (every
    row's position rebuilt, the window admitted) on the card, with the NaN
    rows zeroed for the mask."""
    from repro_torch.kernels.decode_attention import ops as ddops
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import cache as cache_lib
    w, n = 64, 0
    totals = torch.tensor([1, 2, 31, 63, 64, 65, 130, 1000, 4097],
                          device="cuda")
    B = totals.shape[0]
    pos = cache_lib.ring_positions(totals, w)                 # (B, w)
    for Hq, Hkv, hd in ((32, 8, 128), (8, 2, 64), (32, 4, 128)):
        k = torch.randn(B, w, Hkv, hd, generator=gen, device="cuda")
        v = torch.randn(B, w, Hkv, hd, generator=gen, device="cuda")
        stale = (pos < 0)[:, :, None, None]
        k = k.masked_fill(stale, float("nan")).to(dtype)
        v = v.masked_fill(stale, float("nan")).to(dtype)
        q = torch.randn(B, 1, Hq, hd, generator=gen, device="cuda").to(dtype)
        got = ddops.decode_attention(q, k, v,
                                     totals.clamp(max=w).to(torch.int32))
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), "a stale ring row was read"
        qpos = (totals - 1)[:, None]
        mask = (pos <= qpos) & (pos > qpos - w) & (pos >= 0)
        want = attn_lib._grouped_sdpa(q, k.nan_to_num(0.0),
                                      v.nan_to_num(0.0),
                                      mask[:, None, None], Hq // Hkv)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        n += 1
    return n


def device_ms(torch, fn, flush, runs=21, write_flush=False):
    """Median device time of fn() over `runs` runs: each run starts on a
    flushed L2 (the serving path reads another layer's pages in between)
    behind a device sleep long enough for the host to enqueue the whole
    call, so the host's launch overhead is not counted. The flush reads a
    256 MB buffer (a reduction into one element), which leaves L2 full of
    clean lines; `write_flush` zeroes it instead (the older flush), whose
    dirty lines a memory-bound kernel then pays to write back."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if write_flush:
            flush.zero_()
        else:
            flush.sum()
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops, peak=BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(torch):
    """Kernel, plain and library times at the serving shapes (bf16)."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_prefill_attention import ops as pops
    from repro_torch.kernels.paged_prefill_attention import ref as pref
    from repro_torch.models.paged_cache import gather_sequence
    log("== phase 3: timing at the serving shapes (bf16)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    dt = torch.bfloat16
    esz = 2
    rows = {}
    models = {"qwen3-8b": (32, 8), "qwen2-1.5b": (12, 2)}
    page, n_pages, hd = 32, 256, 128   # the engines' page size and pool
    time_decode_kernels(torch, gen, flush, models, rows)
    for model, (Hq, Hkv) in models.items():
        rep = Hq // Hkv
        # ragged ingest: R = 4 rows of C = 128 at offsets 0..384
        C = 128
        offs, lns = [0, 128, 256, 384], [C] * 4
        for name, o, ln in (("paged_prefill_attention_ragged", offs, lns),
                            ("paged_prefill_attention", [256], [C])):
            q, kp, vp, rws, ot, lt = prefill_case(
                torch, gen, Hq, Hkv, hd, page, C, dt, o, ln, share=False,
                n_pages=n_pages)
            if name == "paged_prefill_attention":
                run = functools.partial(pops.paged_prefill_attention, q, kp,
                                        vp, rws[0], ot, lt)
                plain = functools.partial(pref.paged_prefill_attention_ref,
                                          q, kp, vp, rws[0], ot, lt)
            else:
                run = functools.partial(pops.paged_prefill_attention_ragged,
                                        q, kp, vp, rws, ot, lt)
                plain = functools.partial(
                    pref.paged_prefill_attention_ragged_ref, q, kp, vp, rws,
                    ot, lt)
            got, want = run(), plain()
            err = (valid_rows(torch, got, lt)
                   - valid_rows(torch, want, lt)).abs().max().item()
            torch.testing.assert_close(valid_rows(torch, got, lt),
                                       valid_rows(torch, want, lt),
                                       **BF16_TOL)
            gk = gather_sequence(kp, rws).repeat_interleave(rep, 2)
            gv = gather_sequence(vp, rws).repeat_interleave(rep, 2)
            S = gk.shape[1]
            qpos = ot[:, None] + torch.arange(C, device="cuda")[None, :]
            kpos = torch.arange(S, device="cuda")
            mask = ((kpos[None, None, :] <= qpos[:, :, None])
                    & (kpos[None, None, :] < (ot + lt)[:, None, None])
                    )[:, None]
            qs, ks, vs = (q.transpose(1, 2), gk.transpose(1, 2).contiguous(),
                          gv.transpose(1, 2).contiguous())
            tot = [a + b for a, b in zip(o, ln)]
            pairs = sum(sum(a + c + 1 for c in range(b)) for a, b in zip(o, ln))
            nbytes = (2 * sum(ln) * Hq * hd + sum(tot) * Hkv * hd * 2) * esz \
                + (rws.numel() + 2 * len(o)) * 4
            rows[(name, model)] = dict(
                shape=f"R={len(o)} C={C} offsets={o} Hq={Hq} Hkv={Hkv} "
                      f"hd={hd} page={page}",
                max_abs_err=err,
                ms=device_ms(torch, run, flush),
                plain_ms=device_ms(torch, plain, flush),
                library_ms=device_ms(torch, functools.partial(
                    F.scaled_dot_product_attention, qs, ks, vs,
                    attn_mask=mask), flush),
                bound=bound(nbytes, 4 * hd * Hq * pairs))
    time_dense_kernels(torch, gen, flush, models, rows)
    time_quant_kernels(torch, gen, flush, models, rows)
    time_ssm_rms_kernels(torch, gen, flush, rows)
    time_backward_kernels(torch, gen, flush, rows)
    for (name, model), r in rows.items():
        b_ms, b_by = r["bound"]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        old = ("" if "write_flush_ms" not in r else
               f" (write flush {r['write_flush_ms']:.4f} ms)")
        if "library_cold_ms" in r:
            lib += f" (its backward alone, cold: {r['library_cold_ms']:.4f} ms)"
        log(f"{name} [{model}: {r['shape']}] kernel {r['ms']:.4f} ms{old}, "
            f"bound {b_ms:.4f} ms ({b_by}), plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, max_abs_err {r['max_abs_err']:.3g}")
    return rows


def scan_flops(Bb, S, H, P, N):
    """Flops the SSD recurrence needs, whatever algorithm computes it: per
    token and head, one multiply-add for each (p, n) of the state update
    and one for y = C.h, so 4.P.N flops. The chunked form's intra-chunk
    C.B and W.x products are extra work of the algorithm, not counted."""
    return 4 * Bb * S * H * P * N


def time_ssm_rms_kernels(torch, gen, flush, rows):
    """#9 at zamba2's prefill (1 x 1024 and 1 x 256 tokens, 80 heads of P
    64, N 64, float32 as the model feeds it; no single PyTorch call
    computes the scan), bound by the larger of its bytes and its operations
    at the 3xTF32 rate (a float32-accurate kernel on the tensor cores; the
    older bound at the scalar float32 rate is logged beside it) and timed
    at every cluster size the sequence allows, and #10 over 1024 bf16 rows
    of qwen3-8b's width (4096) and of zamba2's gated norm (5120), over
    qwen3-8b's decode
    rows (8 x 4096) and its q-norm rows (8 x 32 heads x 32 positions of
    128), beside `torch.nn.functional.rms_norm` (weight cast to bf16
    beforehand)."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm import ref as rref
    from repro_torch.kernels.ssm_scan import kernel as skernel
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    H, P, N, chunk = 80, 64, 64, 256
    for label, S in (("zamba2-2.7b", 1024), ("zamba2-2.7b S=256", 256)):
        x, dt, A, B, C, _ = scan_inputs(torch, gen, 1, S, H, P, N)
        run = functools.partial(sops.ssm_scan, x, dt, A, B, C, chunk)
        plain = functools.partial(sref.ssd_chunked_ref, x, dt, A, B, C,
                                  chunk)
        (y, h), (yr, hr) = run(), plain()
        torch.testing.assert_close(y, yr, **SCAN_TOL)
        torch.testing.assert_close(h, hr, **SCAN_TOL)
        err = max((y - yr).abs().max().item(), (h - hr).abs().max().item())
        sizes = {"x": x.numel(), "y": y.numel(), "dt": dt.numel(),
                 "A": A.numel(), "B": B.numel(), "C": C.numel(),
                 "state": h.numel()}
        nbytes = 4 * sum(sizes.values())
        flops = scan_flops(1, S, H, P, N)
        scalar_ms, scalar_by = bound(nbytes, flops, F32_FLOPS_PER_S)
        log(f"ssm_scan bound inputs [{label}]: float32 elements {sizes}, "
            f"{nbytes} B; {flops} flops (4.P.N a token and head); bound at "
            f"scalar float32 (67 TFLOP/s) {scalar_ms:.4f} ms ({scalar_by})")
        rows[("ssm_scan", label)] = dict(
            shape=f"Bb=1 S={S} H={H} P={P} N={N} chunk={chunk} float32",
            max_abs_err=err, ms=device_ms(torch, run, flush),
            plain_ms=device_ms(torch, plain, flush), library_ms=None,
            bound=bound(nbytes, flops, TF32X3_FLOPS_PER_S))
        # the split's probe: the same call at other cluster sizes (R = 1:
        # one block walks the whole sequence)
        plan = skernel.split_sequence(1, H, S, skernel.card_blocks(x.device))
        for r in (1, 2, 4, 8):
            if r > -(-S // skernel.CHUNK):
                continue
            ms = device_ms(torch, functools.partial(
                skernel.ssm_scan_cuda, x, dt, A, B, C, None, r), flush)
            log(f"ssm_scan [{label}] at R={r}: {ms:.4f} ms (planner: "
                f"R={plan[0]})")
    for label, R, D in (("qwen3-8b", 1024, 4096), ("zamba2-2.7b", 1024, 5120),
                        ("qwen3-8b decode", 8, 4096),
                        ("qwen3-8b q-norm", 8192, 128)):
        x = torch.randn(R, D, generator=gen, device="cuda").to(torch.bfloat16)
        scale = torch.randn(D, generator=gen, device="cuda")
        run = functools.partial(rops.rmsnorm, x, scale, 1e-6)
        plain = functools.partial(rref.rmsnorm_ref, x, scale, 1e-6)
        got, want = run(), plain()
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
        nbytes = 2 * x.numel() * 2 + D * 4
        rows[("rmsnorm", label)] = dict(
            shape=f"R={R} D={D} bfloat16",
            max_abs_err=(got.float() - want.float()).abs().max().item(),
            ms=device_ms(torch, run, flush),
            plain_ms=device_ms(torch, plain, flush),
            library_ms=device_ms(torch, functools.partial(
                F.rms_norm, x, (D,), scale.to(torch.bfloat16), 1e-6), flush),
            bound=bound(nbytes, 4 * R * D, F32_FLOPS_PER_S))


def time_quant_kernels(torch, gen, flush, models, rows):
    """#5 and #6 at the float kernels' serving shapes over an int8 pool
    (the int8 pipeline's), a bf16 query: kernel, plain (dequantize-gather,
    then attention) and SDPA over the dequantized gather in bf16. The bound
    counts 1 byte per K/V element, 8 bytes of scales per page and kv head
    read, q and out, and the int32 indices. The fp8 pool's kernel time is
    logged beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_prefill_attention import ops as pops
    from repro_torch.kernels.paged_prefill_attention import ref as pref
    from repro_torch.models.paged_cache import gather_sequence_dequant
    dt, page, n_pages, hd = torch.bfloat16, 32, 256, 128
    for model, (Hq, Hkv) in models.items():
        rep = Hq // Hkv
        C = 128
        for name, o, ln in (
                ("paged_prefill_attention_ragged_quant", [0, 128, 256, 384],
                 [C] * 4),
                ("paged_prefill_attention_quant", [256], [C])):
            q, _, _, rws, ot, lt = prefill_case(
                torch, gen, Hq, Hkv, hd, page, C, dt, o, ln, share=False,
                n_pages=1)
            fp8_ms = None
            for kv_dtype in ("fp8", "int8"):
                pools = quant_pools(torch, gen, n_pages, page, Hkv, hd,
                                    kv_dtype)
                if name == "paged_prefill_attention_quant":
                    run = functools.partial(pops.paged_prefill_attention_quant,
                                            q, *pools, rws[0], ot, lt)
                    plain = functools.partial(
                        pref.paged_prefill_attention_quant_ref, q, *pools,
                        rws[0], ot, lt)
                else:
                    run = functools.partial(
                        pops.paged_prefill_attention_ragged_quant, q, *pools,
                        rws, ot, lt)
                    plain = functools.partial(
                        pref.paged_prefill_attention_ragged_quant_ref, q,
                        *pools, rws, ot, lt)
                if kv_dtype == "fp8":
                    fp8_ms = device_ms(torch, run, flush)
            got, want = run(), plain()
            err = (valid_rows(torch, got, lt)
                   - valid_rows(torch, want, lt)).abs().max().item()
            torch.testing.assert_close(valid_rows(torch, got, lt),
                                       valid_rows(torch, want, lt),
                                       **BF16_TOL)
            gk = gather_sequence_dequant(pools[0], pools[2], rws).to(dt)
            gv = gather_sequence_dequant(pools[1], pools[3], rws).to(dt)
            gk, gv = gk.repeat_interleave(rep, 2), gv.repeat_interleave(rep,
                                                                        2)
            S = gk.shape[1]
            qpos = ot[:, None] + torch.arange(C, device="cuda")[None, :]
            kpos = torch.arange(S, device="cuda")
            mask = ((kpos[None, None, :] <= qpos[:, :, None])
                    & (kpos[None, None, :] < (ot + lt)[:, None, None])
                    )[:, None]
            tot = [a + b for a, b in zip(o, ln)]
            pairs = sum(sum(a + c + 1 for c in range(b))
                        for a, b in zip(o, ln))
            pages_read = sum(-(-t // page) for t in tot)
            nbytes = (2 * sum(ln) * Hq * hd * 2 + sum(tot) * Hkv * hd * 2
                      + pages_read * Hkv * 2 * 4
                      + (rws.numel() + 2 * len(o)) * 4)
            log(f"{name} [{model}]: fp8 pool kernel {fp8_ms:.4f} ms")
            rows[(name, model)] = dict(
                shape=f"R={len(o)} C={C} offsets={o} Hq={Hq} Hkv={Hkv} "
                      f"hd={hd} page={page} int8 pool",
                max_abs_err=err,
                ms=device_ms(torch, run, flush),
                plain_ms=device_ms(torch, plain, flush),
                library_ms=device_ms(torch, functools.partial(
                    F.scaled_dot_product_attention, q.transpose(1, 2),
                    gk.transpose(1, 2).contiguous(),
                    gv.transpose(1, 2).contiguous(), attn_mask=mask), flush),
                bound=bound(nbytes, 4 * hd * Hq * pairs))


def time_dense_kernels(torch, gen, flush, models, rows):
    """The flash kernel at B = 1, S = 1024, causal (bf16, head_dim 128),
    at phase 6's monolithic prefill (qwen3-8b, B = 4, S = 256) and at
    whisper-tiny's encoder (phase 13's B = 8 x 1,500 frames, 6 heads of
    64, not causal). Bound inputs are logged beside each time."""
    hd = 128
    for model, (Hq, Hkv) in models.items():
        rows[("flash_attention", model)] = flash_row(
            torch, gen, flush, model, 1, 1024, Hq, Hkv, hd)
    # monolithic prefill of phase 6's batch: 4 prompts of 256 tokens
    rows[("flash_attention", "qwen3-8b B=4 S=256")] = flash_row(
        torch, gen, flush, "qwen3-8b B=4 S=256", 4, 256,
        *models["qwen3-8b"], hd)
    rows[("flash_attention", WHISPER_ENCODER_ROW)] = flash_row(
        torch, gen, flush, WHISPER_ENCODER_ROW, 8, 1500, 6, 6, 64,
        causal=False)


WHISPER_ENCODER_ROW = "whisper-tiny encoder B=8 S=1500"


# The decode kernels' timed shapes (B = 8 slots): label suffix, each slot's
# length. The first is the shape the older rows were timed at (context
# 512); then phase 6's decode batch (4 of the 8 slots live at about 272
# keys, the rest inactive) and the engines' max_len (1,024).
DECODE_SHAPES = (("", [512] * 8), (" 4 of 8 live at 272", [272] * 4 + [0] * 4),
                 (" ctx=1024", [1024] * 8))


def time_decode_kernels(torch, gen, flush, models, rows):
    """#1, #4 (over an int8 pool; the fp8 pool's time logged beside it) and
    #8 at each DECODE_SHAPES shape, bf16 query, head_dim 128, page 32 (the
    block table trimmed to the live pages, as the engines trim it), the
    dense cache a 1,024-row cache read over its live rows as the engine
    reads it, NaN past each length: kernel, plain and SDPA (over the
    gathered, head-repeated K/V with a length mask; dequantized for #4),
    each under the read flush, and the kernel also under the write flush
    the older rows were timed under. The bound counts each live K/V byte
    once (1 a value for int8, plus 8 bytes of scales per page and kv
    head), q and out, and the int32 indices."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as ddops
    from repro_torch.kernels.decode_attention import ref as ddref
    from repro_torch.kernels.paged_decode_attention import ops as dops
    from repro_torch.kernels.paged_decode_attention import ref as dref
    from repro_torch.models.paged_cache import (gather_sequence,
                                                gather_sequence_dequant)
    dt, page, hd, S = torch.bfloat16, 32, 128, 1024
    for model, (Hq, Hkv) in models.items():
        rep = Hq // Hkv
        for suffix, lens in DECODE_SHAPES:
            label = model + suffix
            B, live = len(lens), max(lens)
            P = -(-live // page)
            n_pages = B * P + 2
            q, kp, vp, tbl, ln = decode_case(torch, gen, B, Hq, Hkv, hd,
                                             page, P, dt, lens=lens,
                                             n_pages=n_pages)
            n_tok = int(ln.sum())
            pages_read = sum(-(-x // page) for x in lens)
            qs = q.transpose(1, 2)

            def sdpa(k, v):
                """SDPA over (B, S, Hkv, hd) K/V, heads repeated, with a
                length mask."""
                mask = (torch.arange(k.shape[1], device="cuda")[None, :]
                        < ln[:, None])[:, None, None]
                return functools.partial(
                    F.scaled_dot_product_attention, qs,
                    k.repeat_interleave(rep, 2).transpose(1, 2).contiguous(),
                    v.repeat_interleave(rep, 2).transpose(1, 2).contiguous(),
                    attn_mask=mask)
            flops = 4 * hd * Hq * n_tok
            io = 2 * q.numel() * 2 + (tbl.numel() + B) * 4
            shape = (f"B={B} lengths={sorted(set(lens), reverse=True)} "
                     f"Hq={Hq} Hkv={Hkv} hd={hd} page={page}")

            def row(name, run, plain, library, nbytes, extra=""):
                got, want = run(), plain()
                torch.testing.assert_close(got.float(), want.float(),
                                           **BF16_TOL)
                r = dict(shape=shape + extra,
                         max_abs_err=(got.float()
                                      - want.float()).abs().max().item(),
                         ms=device_ms(torch, run, flush),
                         plain_ms=device_ms(torch, plain, flush),
                         library_ms=device_ms(torch, library, flush),
                         bound=bound(nbytes, flops))
                r["write_flush_ms"] = device_ms(torch, run, flush,
                                                write_flush=True)
                rows[(name, label)] = r
                log(f"{name} bound inputs [{label}]: {nbytes} B, {flops} "
                    f"flops; kernel under the write flush "
                    f"{r['write_flush_ms']:.4f} ms")

            row("paged_decode_attention",
                functools.partial(dops.paged_decode_attention, q, kp, vp,
                                  tbl, ln),
                functools.partial(dref.paged_decode_attention_ref, q, kp, vp,
                                  tbl, ln),
                sdpa(gather_sequence(kp, tbl), gather_sequence(vp, tbl)),
                n_tok * Hkv * hd * 2 * 2 + io)
            fp8 = quant_pools(torch, gen, n_pages, page, Hkv, hd, "fp8")
            fp8_ms = device_ms(torch, functools.partial(
                dops.paged_decode_attention_quant, q, *fp8, tbl, ln), flush)
            kv = quant_pools(torch, gen, n_pages, page, Hkv, hd, "int8")
            row("paged_decode_attention_quant",
                functools.partial(dops.paged_decode_attention_quant, q, *kv,
                                  tbl, ln),
                functools.partial(dref.paged_decode_attention_quant_ref, q,
                                  *kv, tbl, ln),
                sdpa(gather_sequence_dequant(kv[0], kv[2], tbl).to(dt),
                     gather_sequence_dequant(kv[1], kv[3], tbl).to(dt)),
                n_tok * Hkv * hd * 2 + pages_read * Hkv * 8 + io,
                f" int8 pool (fp8 pool: kernel {fp8_ms:.4f} ms)")
            k, v = poisoned_cache(torch, gen, B, S, Hkv, hd, dt, ln)
            k, v = k[:, :live], v[:, :live]
            row("decode_attention",
                functools.partial(ddops.decode_attention, q, k, v, ln),
                functools.partial(ddref.decode_attention_ref, q, k, v, ln),
                sdpa(k.nan_to_num(0.0), v.nan_to_num(0.0)),
                n_tok * Hkv * hd * 2 * 2 + 2 * q.numel() * 2 + B * 4,
                f" dense cache of {S} rows read over {live}")


def flash_row(torch, gen, flush, label, B, S, Hq, Hkv, hd, causal=True):
    """#7 at (B, S), causal or not, bf16: kernel, plain and SDPA (over
    head-repeated K/V, is_causal as the kernel's) times, the bound by 4 * hd
    flops a kept (query, key) pair against q, k, v and out read or written
    once."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention import ref as faref
    dt, esz, rep = torch.bfloat16, 2, Hq // Hkv
    q = torch.randn(B, S, Hq, hd, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dt)
    got = faops.flash_attention(q, k, v, causal=causal)
    want = faref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    pairs = B * S * (S + 1) // 2 if causal else B * S * S
    flops = 4 * hd * Hq * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * esz
    log(f"flash_attention bound inputs [{label}]: {flops} flops "
        f"(4 * hd * Hq * {'B * S(S+1)/2' if causal else 'B * S * S'}); q/out {2 * q.numel() * esz} B + "
        f"k/v {2 * k.numel() * esz} B; launch shape (rows, key groups) "
        f"{flash_launch_shape(torch, B, S, Hq, Hkv, hd)}")
    qs = q.transpose(1, 2)
    ks = k.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    vs = v.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    return dict(
        shape=f"B={B} S={S} {'causal' if causal else 'not causal'} Hq={Hq} "
              f"Hkv={Hkv} hd={hd}",
        max_abs_err=(got.float() - want.float()).abs().max().item(),
        ms=device_ms(torch, functools.partial(
            faops.flash_attention, q, k, v, causal=causal), flush),
        plain_ms=device_ms(torch, functools.partial(
            faref.flash_attention_ref, q, k, v, causal=causal), flush),
        library_ms=device_ms(torch, functools.partial(
            F.scaled_dot_product_attention, qs, ks, vs, is_causal=causal),
            flush),
        bound=bound(nbytes, flops))


def phase_tiny_parity(torch):
    """The TINY test config through the port's engines on cuda and on cpu:
    dense, monolithic paged (prefill_chunk 0) and chunked paged."""
    from repro_torch.models import transformer
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.engine import InferenceEngine
    log("== phase 4: TINY engines, card against CPU")
    tiny = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                       max_seq_len=512, dtype="float32", remat=False)
    prompts = [[65 + i for i in range(43)], [70, 71], [80] * 40, [90] * 17,
               [5] * 64]
    cpu_params = transformer.init_params(tiny, seed=0, device="cpu")
    cuda_params = _to(cpu_params, "cuda")

    def engine(device, backend, chunk, page, kv_dtype=""):
        return InferenceEngine(tiny.with_(prefill_chunk=chunk,
                                          kv_dtype=kv_dtype),
                               cuda_params if device == "cuda"
                               else cpu_params, max_batch=3, max_len=128,
                               page_size=page, kv_backend=backend,
                               device=device)

    on_card = {}
    for variant in (("dense", 0, 16), ("paged", 0, 16), ("paged", 16, 8),
                    ("paged", 16, 16)):
        on_card[variant] = engine("cuda", *variant).generate(prompts,
                                                             max_new=12)
        on_cpu = engine("cpu", *variant).generate(prompts, max_new=12)
        _same_greedy(torch, on_card[variant], on_cpu,
                     lambda: engine("cpu", *variant), prompts, variant)
        log(f"{variant[0]} prefill_chunk={variant[1]} page={variant[2]}: "
            f"{len(prompts)} requests, greedy tokens equal, logprobs within "
            f"rtol 1e-4 atol 1e-5")
    _same_greedy(torch, on_card[("dense", 0, 16)], on_card[("paged", 0, 16)],
                 lambda: engine("cpu", "dense", 0, 16), prompts,
                 "dense vs monolithic paged on the card")
    log("dense and monolithic paged engines give the same greedy tokens on "
        "the card")
    # Quantized pools: the card and the CPU store the same quantized pages
    # up to float noise, but an element that noise moves across a rounding
    # boundary lands a whole quantization step away, which moves later
    # logits by about 1e-3: logprobs are held to atol 1e-2, and tokens may
    # part only at a CPU top-2 margin under 0.05.
    for variant in (("paged", 0, 16, "int8"), ("paged", 16, 8, "int8"),
                    ("paged", 0, 16, "fp8"), ("paged", 16, 16, "fp8")):
        got = engine("cuda", *variant).generate(prompts, max_new=12)
        want = engine("cpu", *variant).generate(prompts, max_new=12)
        _same_greedy(torch, got, want, lambda: engine("cpu", *variant),
                     prompts, variant, margin=0.05, rtol=0.0, atol=1e-2)
        log(f"paged prefill_chunk={variant[1]} page={variant[2]} "
            f"kv_dtype={variant[3]}: {len(prompts)} requests, greedy tokens "
            f"equal, logprobs within atol 1e-2")
    ssm_tiny_parity(torch, prompts)
    tiny_eviction_parity(torch)
    family_tiny_parity(torch, prompts)
    stub_input_tiny_parity(torch)


# phase 4's gate on logits and logprobs, card against CPU
TINY_TOL = dict(rtol=1e-4, atol=1e-5)


def stub_input_tiny_parity(torch):
    """whisper-tiny.reduced() (a 2-layer encoder over 64 stub frames) and
    internvl2-2b.reduced() (16 stub patch embeddings), float32, card
    against CPU at the first tolerance: `encode`, `forward`, dense
    `prefill` of prompts of 12 and 37 padded to 64 and 8 greedy decode
    steps through the step builders (tokens equal), and 3 train steps at
    phase 11's gates."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.training import optimizer as topt
    f32 = dict(dtype="float32", remat=False)
    rng = np.random.default_rng(0)
    toks = np.zeros((2, 64), np.int64)
    toks[0, :12] = rng.integers(1, 512, 12)
    toks[1, :37] = rng.integers(1, 512, 37)
    plens = np.array([12, 37], np.int32)
    for arch in ("whisper-tiny", "internvl2-2b"):
        cfg = get_config(arch).reduced(**f32)
        if cfg.family == "encdec":
            key, width, n = "enc_frames", cfg.encoder.d_model, \
                cfg.encoder.n_ctx
        else:
            key, width, n = "prefix_embeds", cfg.d_model, cfg.n_prefix_tokens
        stub = rng.standard_normal((2, n, width)).astype(np.float32)
        cpu = transformer.init_params(cfg, seed=0, device="cpu")
        card = _to(cpu, "cuda")
        out = {}
        for dev, params in (("cuda", card), ("cpu", cpu)):
            extra = {key: torch.from_numpy(stub).to(dev)}
            tok = torch.from_numpy(toks).to(dev)
            r = {}
            if cfg.family == "encdec":
                r["encode"] = transformer.encode(cfg, params["encoder"],
                                                 extra[key])
            r["forward"], _ = transformer.forward(cfg, params, tok[:, :40],
                                                  **extra)
            cache = transformer.init_cache(cfg, 2, 128, device=dev)
            logits, cache = steps.make_prefill_step(cfg)(
                params, tok, cache, plens, **extra)
            decode = steps.make_decode_step(cfg)
            steps_out, gen = [logits], []
            for _ in range(8):
                nxt = steps_out[-1].argmax(-1)[:, None]
                gen.append(nxt)
                logits, cache = decode(params, nxt, cache)
                steps_out.append(logits)
            r["prefill+decode"] = torch.stack(steps_out)
            r["tokens"] = torch.cat(gen, 1)
            out[dev] = {k: v.cpu() for k, v in r.items()}
        assert torch.equal(out["cuda"]["tokens"], out["cpu"]["tokens"]), arch
        for k in out["cpu"]:
            if k != "tokens":
                torch.testing.assert_close(out["cuda"][k], out["cpu"][k],
                                           **TINY_TOL)
        log(f"{arch} reduced: {', '.join(k for k in out['cpu'] if k != 'tokens')}"
            f" with {key} {tuple(stub.shape)}, card against CPU within rtol "
            f"1e-4 atol 1e-5, greedy tokens equal")
        batches = []
        for i in range(3):
            b = np.random.default_rng(10 + i)
            batches.append((b.integers(1, 512, (2, 48)),
                            b.integers(1, 512, (2, 48)),
                            {key: b.standard_normal((2, n, width)).astype(
                                np.float32)}))
        opt_cfg = topt.AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                                   total_steps=3)
        train_card_vs_cpu(torch, f"{arch} reduced", cfg, batches, opt_cfg)


def family_tiny_parity(torch, prompts):
    """The families of phase 12 reduced, float32, card against CPU at the
    first tolerance, each at its config's own capacity factor (1.25, so
    assignments drop): qwen3-moe-30b-a3b.reduced() and a top-8 variant (16
    experts, k = 8) on the dense, monolithic paged and chunked paged
    engines; mixtral-8x7b.reduced(sliding_window=64) on the dense engine
    (the paged cache refuses a window) with prompts of 70 and 100 tokens
    padded to 128, past the window; granite-3-8b.reduced() and
    minitron-8b.reduced() on the chunked paged engine."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.serving.engine import InferenceEngine
    f32 = dict(dtype="float32", remat=False)
    qwen = get_config("qwen3-moe-30b-a3b").reduced(**f32)
    long_prompts = prompts + [[(3 * i) % 97 + 1 for i in range(70)],
                              [(5 * i) % 89 + 1 for i in range(100)]]
    runs = [("qwen3-moe", qwen, prompts, (("dense", 0), ("paged", 0),
                                          ("paged", 16))),
            ("qwen3-moe-top8", qwen.with_(n_experts=16, experts_per_token=8),
             prompts, (("dense", 0), ("paged", 0), ("paged", 16))),
            ("mixtral-w64", get_config("mixtral-8x7b").reduced(
                sliding_window=64, **f32), long_prompts, (("dense", 0),)),
            ("granite", get_config("granite-3-8b").reduced(**f32), prompts,
             (("paged", 16),)),
            ("minitron", get_config("minitron-8b").reduced(**f32), prompts,
             (("paged", 16),))]
    for name, cfg, ps, variants in runs:
        cpu_params = transformer.init_params(cfg, seed=0, device="cpu")
        cuda_params = _to(cpu_params, "cuda")
        for backend, chunk in variants:
            def engine(device):
                return InferenceEngine(
                    cfg.with_(prefill_chunk=chunk),
                    cuda_params if device == "cuda" else cpu_params,
                    max_batch=3, max_len=256, page_size=16,
                    kv_backend=backend, device=device)
            got = engine("cuda").generate(ps, max_new=12)
            want = engine("cpu").generate(ps, max_new=12)
            _same_greedy(torch, got, want, lambda: engine("cpu"), ps,
                         (name, backend, chunk))
            log(f"{name} {backend} prefill_chunk={chunk} (capacity factor "
                f"{cfg.capacity_factor}, window {cfg.sliding_window}): "
                f"{len(ps)} requests, greedy tokens equal, logprobs within "
                f"rtol 1e-4 atol 1e-5")


def tiny_eviction_parity(torch):
    """TINY_CLOUD (float32) on chunked paged engines whose pool (6 pages of
    8) cannot hold its 4 requests, card against CPU: resumed by host swap,
    by replay, and under the serial one-chunk scheduler (which swaps)."""
    from repro_torch.configs.pice_cloud_edge import TINY_CLOUD
    from repro_torch.models import transformer
    from repro_torch.serving.engine import InferenceEngine
    cfg = TINY_CLOUD.with_(dtype="float32", prefill_chunk=16)
    cpu_params = transformer.init_params(cfg, seed=0, device="cpu")
    cuda_params = _to(cpu_params, "cuda")
    prompts = [[65, 66, 67, 68], [70, 71], [80, 81, 82],
               [90, 91, 92, 93, 94]]

    def engine(device, **kw):
        return InferenceEngine(cfg, cuda_params if device == "cuda"
                               else cpu_params, max_batch=3, max_len=64,
                               page_size=8, n_pages=6, device=device, **kw)
    for label, kw in (("host swap", {}), ("replay", dict(host_swap=False)),
                      ("serial scheduler", dict(ragged_ingest=False))):
        card, cpu = engine("cuda", **kw), engine("cpu", **kw)
        got = card.generate(prompts, max_new=24)
        want = cpu.generate(prompts, max_new=24)
        _same_greedy(torch, got, want, lambda: engine("cpu", **kw), prompts,
                     ("tiny-cloud tight pool", label))
        for eng in (card, cpu):
            assert eng.evictions > 0, f"{label}: nothing was evicted"
            if eng.host_swap:
                assert eng.swap_outs > 0 and eng.swap_ins == eng.swap_outs
            else:
                assert eng.swap_outs == 0
            assert eng.alloc.pages_in_use == 0 and not eng.alloc.hosted
        log(f"tiny-cloud, 6 pages of 8, {label}: {len(prompts)} requests, "
            f"{card.evictions} evictions, {card.swap_outs} swap-outs, "
            f"{card.swap_ins} swap-ins on the card; greedy tokens equal to "
            f"the CPU's, logprobs within rtol 1e-4 atol 1e-5")


def ssm_tiny_parity(torch, prompts):
    """TINY_EDGE_C, xlstm-1.3b cut to 4 layers (sLSTM, mLSTM, sLSTM, mLSTM;
    chunks of 16) and zamba2 cut to 4 layers (the shared block twice),
    float32, on the dense and paged engines, card against CPU; a fan-out
    of four identical one-token suffixes on 3 slots, whose late forks must
    match its early ones; the 4-layer zamba2 over an int8 pool."""
    from repro_torch.configs.pice_cloud_edge import TINY_EDGE_C
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.serving.engine import InferenceEngine
    cfgs = {"tiny-edge-c": TINY_EDGE_C.with_(dtype="float32"),
            "xlstm-4l": get_config("xlstm-1.3b").reduced().with_(
                n_layers=4, slstm_at=(0, 2), ssm_chunk=16, dtype="float32",
                remat=False),
            "zamba2-4l": get_config("zamba2-2.7b").reduced().with_(
                n_layers=4, dtype="float32", remat=False)}
    for name, cfg in cfgs.items():
        cpu_params = transformer.init_params(cfg, seed=0, device="cpu")
        cuda_params = _to(cpu_params, "cuda")

        def engine(device, backend, kv_dtype=""):
            return InferenceEngine(cfg.with_(kv_dtype=kv_dtype),
                                   cuda_params if device == "cuda"
                                   else cpu_params, max_batch=3, max_len=128,
                                   page_size=16, kv_backend=backend,
                                   device=device)
        for backend in ("dense", "paged"):
            got = engine("cuda", backend).generate(prompts, max_new=12)
            want = engine("cpu", backend).generate(prompts, max_new=12)
            _same_greedy(torch, got, want, lambda: engine("cpu", backend),
                         prompts, (name, backend))
            log(f"{name} {backend}: {len(prompts)} requests, greedy tokens "
                f"equal, logprobs within rtol 1e-4 atol 1e-5")
        prefix = [(7 * i) % 200 + 1 for i in range(32)]
        fan = {dev: engine(dev, "paged").generate_fanout(prefix, [[7]] * 4,
                                                         max_new=8)
               for dev in ("cuda", "cpu")}
        assert all(f == fan["cuda"][0] for f in fan["cuda"]), \
            "late forks part from early ones"
        _same_greedy(torch, fan["cuda"], fan["cpu"],
                     lambda: engine("cpu", "paged"), [prefix + [7]] * 4,
                     (name, "fan-out"))
        log(f"{name} fan-out: 4 one-token forks on 3 slots, late forks equal "
            f"early ones, card equal to CPU")
    got = engine("cuda", "paged", "int8").generate(prompts, max_new=12)
    want = engine("cpu", "paged", "int8").generate(prompts, max_new=12)
    _same_greedy(torch, got, want, lambda: engine("cpu", "paged", "int8"),
                 prompts, ("zamba2-4l", "int8"), margin=0.05, rtol=0.0,
                 atol=1e-2)
    log("zamba2-4l paged kv_dtype=int8: greedy tokens equal, logprobs within "
        "atol 1e-2")


def _same_greedy(torch, got, want, cpu_engine, prompts, what, margin=1e-4,
                 rtol=1e-4, atol=1e-5):
    """Greedy tokens equal (a part at a CPU top-2 logit margin under
    `margin` ends the comparison of that request) and logprobs within
    rtol, atol up to there."""
    for i, ((tg, lg), (tc, lc)) in enumerate(zip(got, want)):
        n = len(tc)
        for t in range(min(len(tg), len(tc))):
            if tg[t] != tc[t]:
                m = _cpu_margin(torch, cpu_engine(), prompts[i], tc[:t])
                log(f"{what} request {i}: tokens part at step {t}, cpu "
                    f"top-2 logit margin {m:.3g}")
                assert m < margin, "tokens diverge at a clear margin"
                n = t
                break
        assert tg[:n] == tc[:n], f"{what} request {i}: tokens diverge"
        torch.testing.assert_close(torch.tensor(lg[:n]),
                                   torch.tensor(lc[:n]), rtol=rtol,
                                   atol=atol)


def _cpu_margin(torch, eng, prompt, prefix):
    """Top-2 logit margin of the cpu engine's next-token logits after
    prompt + prefix (teacher-forced)."""
    seen = []
    draw = eng._first_draws
    eng._first_draws = lambda rows: (seen.append(rows[0][1]), draw(rows))[1]
    eng.generate([list(prompt) + list(prefix)], max_new=1)
    top = torch.topk(seen[0][0].float(), 2).values
    return float(top[0] - top[1])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _cloned(tree):
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cloned(v) for v in tree]
    return tree.clone()


def kernel_counters():
    """Every kernel wrapper of the port, by the name its counter reports."""
    from repro_torch import kernels
    return kernels.wrappers()


# the wrappers that launch once per attention layer of a model call
ATTENTION_KERNELS = ("paged_decode_attention",
                     "paged_prefill_attention_ragged",
                     "paged_prefill_attention",
                     "paged_decode_attention_quant",
                     "paged_prefill_attention_ragged_quant",
                     "paged_prefill_attention_quant", "decode_attention",
                     "flash_attention")


def counted(torch, fn):
    """fn() with every launch counter set to 0 just before it; returns
    (fn's result, {kernel: launches}) read just after."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: c.launches for name, c in counters.items()}


class MonolithicPrefills:
    """Counts each engine's monolithic prefills (`_prefill_into` on a dense
    engine or a paged one that does not chunk) inside the `with`, and the
    flash launches they must make: one an attention layer each."""

    def __init__(self, engines):
        self.engines, self.counts = engines, {}

    def __enter__(self):
        for name, eng in self.engines.items():
            self.counts[name] = 0
            if eng.kv_backend == "paged" and eng.prefill_chunk:
                continue
            inner = eng._prefill_into

            def counted_prefill(*args, _name=name, _inner=inner, **kw):
                self.counts[_name] += 1
                return _inner(*args, **kw)
            eng._prefill_into = counted_prefill
        return self

    def __exit__(self, *exc):
        for eng in self.engines.values():
            eng.__dict__.pop("_prefill_into", None)

    def flash_launches(self):
        return sum(n * attention_layers(self.engines[name].cfg)
                   for name, n in self.counts.items())


def profile_prompts(n=256):
    """Phase 6's batch: 4 prompts of `n` tokens (256 but for the rows of
    PROFILE_PROMPT)."""
    return [[(7 * i + j) % 251 + 1 for j in range(n)] for i in range(4)]


def pin_progressive(scheduler):
    """Make `scheduler` answer progressive at its first sketch level with
    its first edge model wherever it would answer cloud_full."""
    from repro_torch.core.scheduler import ScheduleDecision
    decide = scheduler.schedule

    def schedule(expected_len, sla=None, parallelism=None):
        d = decide(expected_len, sla=sla, parallelism=parallelism)
        if d.mode == "progressive":
            return d
        sk = max(scheduler.levels(expected_len)[1], 1)
        return ScheduleDecision(
            mode="progressive", sketch_tokens=sk, level=1,
            edge_model=next(iter(scheduler.edges)),
            parallelism=scheduler.estimate_parallelism(sk))
    scheduler.schedule = schedule


def engine_busy_s(spans, since_ns: int) -> dict:
    """Host wall in seconds of each engine's top-level `engine.*` spans
    (steps, prefix prefills, admissions) that began at `since_ns` or later
    on the `perf_counter` clock, by engine name."""
    by_id = {s.id: s for s in spans}
    busy = {}
    for s in spans:
        parent = by_id.get(s.parent)
        if s.start < since_ns or not s.name.startswith("engine.") or (
                parent is not None and parent.name.startswith("engine.")):
            continue
        name = s.attrs["engine"]
        busy[name] = busy.get(name, 0.0) + (s.end - s.start) / 1e9
    return busy


def run_pipeline(torch, engines, n_requests, label):
    """Profile the engines, build the PICE pipeline (qwen3-8b cloud) and
    answer `n_requests` corpus requests, counting kernel launches over the
    requests: the flash kernel's must be one an attention layer for each
    monolithic prefill. Every edge model expands every progressive
    request (the ensemble holds the whole edge fleet). Returns (the
    launches, the tokens each engine generated).

    The scheduler picks cloud_full or progressive per request from the
    engines' profiled rates, and those vary between calls (the edge's cost
    coefficient ranged over 0.54-1.03 in one call), so it may answer every
    request from the cloud. Then one more request is answered with the
    decision pinned to progressive, so that the run always drives the edge
    fan-out (and its single-slot prefill kernel)."""
    from repro_torch import trace
    from repro_torch.data import corpus
    from repro_torch.launch import serve
    from repro_torch.serving.requests import Request, Response
    pipe = serve.build_pipeline(engines, serve.CAPABILITIES,
                                log_fn=log, cloud_name="qwen3-8b")
    pipe.cfg.ensemble_size = len(engines) - 1
    before = {n: e.tokens_generated for n, e in engines.items()}

    def ask(ex):
        resp = pipe.handle(Request(query=ex.query, category=ex.category,
                                   max_new_tokens=96))
        assert isinstance(resp, Response)
        log(serve.response_line(resp, 0.0))
        return resp.mode

    def answer():
        examples = corpus.corpus(n_requests, seed=7)
        modes = [ask(ex) for ex in examples]
        if "progressive" not in modes:
            log(f"{label}: no request went progressive; one more with the "
                f"decision pinned to progressive")
            pin_progressive(pipe.scheduler)
            long_ex = max(examples, key=lambda ex: pipe.predict_length(
                Request(query=ex.query, category=ex.category)))
            modes.append(ask(long_ex) + " (pinned)")
        return modes

    t0 = time.perf_counter()
    trace.enable()
    try:
        with MonolithicPrefills(engines) as mono:
            modes, launches = counted(torch, answer)
    finally:
        trace.disable()
    wall = time.perf_counter() - t0
    log(f"{label} pipeline: {len(modes)} requests in {wall:.2f} s, modes "
        f"{modes}")
    busy_of = engine_busy_s(trace.spans(), int(t0 * 1e9))
    generated = {}
    for name, e in engines.items():
        toks = e.tokens_generated - before[name]
        busy = busy_of.get(e.name, 0.0)
        generated[name] = toks
        log(f"  {name} ({label}): {toks} tokens in {busy:.2f} s busy "
            f"({toks / max(busy, 1e-9):.1f} tok/s)")
    log(f"  kernel launches on the {label} pipeline run: {launches}; "
        f"monolithic prefills {mono.counts}")
    assert launches["flash_attention"] == mono.flash_launches(), \
        "a monolithic prefill layer did not run the flash kernel once"
    return launches, generated


class FiniteLogits:
    """Counts non-finite entries of every logits row the engines sample
    from (through `token_logprob`) on the device inside the `with`; read
    once at the end."""

    def __init__(self, torch):
        from repro_torch.serving import engine as engine_mod
        self.mod = engine_mod
        self.bad = torch.zeros((), dtype=torch.int64, device="cuda")
        self.rows = 0

    def __enter__(self):
        inner = self.inner = self.mod.token_logprob

        def checked(logits, toks):
            self.bad.add_((~logits.isfinite()).sum())
            self.rows += logits.shape[0]
            return inner(logits, toks)
        self.mod.token_logprob = checked
        return self

    def __exit__(self, *exc):
        self.mod.token_logprob = self.inner


def phase_full_width(torch):
    """Phase 5: the full-width paths, each with its own launch counts."""
    import math
    import numpy as np
    from repro_torch.configs.pice_cloud_edge import cloud_config, edge_configs
    from repro_torch.models import transformer
    from repro_torch.serving import engine as engine_mod
    log("== phase 5: full width (random bf16 weights)")
    # zamba2 and xlstm-1.3b are recurrent: their engines prefill
    # monolithically whatever prefill_chunk says
    edges = edge_configs()
    cfgs = {"qwen3-8b": cloud_config().with_(prefill_chunk=128),
            "qwen2-1.5b": edges["qwen2-1.5b"].with_(prefill_chunk=128),
            "zamba2-2.7b": edges["zamba2-2.7b"],
            "xlstm-1.3b": edges["xlstm-1.3b"]}
    kw = dict(max_batch=8, max_len=1024, device="cuda")
    engines, dense = {}, {}
    for seed, (name, cfg) in enumerate(cfgs.items()):
        t0 = time.perf_counter()
        params = transformer.init_params(cfg, seed=seed, device="cuda")
        engines[name] = engine_mod.InferenceEngine(
            cfg, params, page_size=32, name=name, **kw)
        # the same weight tensors: no second copy
        dense[name] = engine_mod.InferenceEngine(
            cfg, params, kv_backend="dense", name=name, **kw)
        cache_b = sum(seg[k].numel() * seg[k].element_size()
                      for seg in dense[name].cache["segments"] for k in seg)
        tensors = list(engine_mod._tensors(params))
        log(f"{name}: {cfg.param_count() / 1e9:.2f} B params by "
            f"param_count(), {sum(t.numel() for t in tensors) / 1e9:.3f} B "
            f"in its tensors ("
            f"{sum(t.numel() * t.element_size() for t in tensors) / 1e9:.3f}"
            f" GB, {cfg.dtype} and float32), pool {engines[name].n_pages} "
            f"pages, dense cache {cache_b / 1e9:.3f} GB (recurrent states "
            f"included: {state_bytes(dense[name]) / 1e9:.3f} GB), prefill "
            f"chunk {engines[name].prefill_chunk}, built in "
            f"{time.perf_counter() - t0:.1f} s")
    # the same weight tensors over int8 pools (the attention stacks)
    quant = {name: engine_mod.InferenceEngine(
        cfgs[name].with_(kv_dtype="int8"), engines[name].params,
        page_size=32, name=name, **kw) for name in ("qwen3-8b", "qwen2-1.5b")}
    mono = engine_mod.InferenceEngine(
        cfgs["qwen3-8b"].with_(prefill_chunk=0), engines["qwen3-8b"].params,
        page_size=32, name="qwen3-8b-monolithic", **kw)
    mono_fp8 = engine_mod.InferenceEngine(
        cfgs["qwen3-8b"].with_(prefill_chunk=0, kv_dtype="fp8"),
        engines["qwen3-8b"].params, page_size=32,
        name="qwen3-8b-monolithic-fp8", **kw)
    for name, eng in quant.items():
        log(f"{name} int8 pool: {eng._page_kv_bytes} B a page over every "
            f"layer (bf16 pool: {engines[name]._page_kv_bytes} B)")
    zamba, xlstm = engines["zamba2-2.7b"], engines["xlstm-1.3b"]
    log(f"zamba2-2.7b: {zamba._page_kv_bytes} B a page over its "
        f"{attention_layers(zamba.cfg)} shared-attention applications; "
        f"Mamba2 states (SSD and conv) {state_bytes(zamba)} B for "
        f"{kw['max_batch']} slots")
    log(f"xlstm-1.3b: {xlstm._page_kv_bytes} B a page (no attention "
        f"layer); mLSTM states {state_bytes(xlstm, ('mlstm',))} B, sLSTM "
        f"states {state_bytes(xlstm, ('slstm',))} B for {kw['max_batch']} "
        f"slots ({state_bytes(xlstm) / kw['max_batch'] / 1e6:.1f} MB a "
        f"slot)")
    torch.cuda.reset_peak_memory_stats()
    paths = {}
    with FiniteLogits(torch) as finite:
        paths["chunked paged pipeline"], made = run_pipeline(
            torch, engines, 3, "chunked paged")
        assert made["zamba2-2.7b"] > 0, "zamba2 expanded nothing"
        assert made["xlstm-1.3b"] > 0, "xlstm-1.3b expanded nothing"
        paths["int8 chunked paged pipeline"], _ = run_pipeline(
            torch, quant, 3, "int8 chunked paged")
        for name in quant:
            log(f"  {name} kv_bytes_read on the pipelines: int8 "
                f"{quant[name].kv_bytes_read} B, bf16 "
                f"{engines[name].kv_bytes_read} B")
        paths["dense pipeline"], made = run_pipeline(torch, dense, 2, "dense")
        assert made["zamba2-2.7b"] > 0, "zamba2 expanded nothing"
        assert made["xlstm-1.3b"] > 0, "xlstm-1.3b expanded nothing"
        xlstm_prefill(torch, xlstm)
        for label, eng in (("monolithic paged generate", mono),
                           ("monolithic paged fp8 generate", mono_fp8),
                           ("zamba2 monolithic paged generate", zamba),
                           ("xlstm monolithic paged generate", xlstm)):
            t0 = time.perf_counter()
            with MonolithicPrefills({label: eng}) as mono:
                _, paths[label] = counted(
                    torch, lambda: eng.generate(profile_prompts(), max_new=32))
            log(f"{label} {eng.cfg.name}: 4 x 256-token prompts, 32 new "
                f"tokens each, in {time.perf_counter() - t0:.2f} s; "
                f"{mono.counts[label]} monolithic prefills; launches "
                f"{paths[label]}")
            assert paths[label]["flash_attention"] == mono.flash_launches(), \
                f"{label}: one flash launch an attention layer a prefill"
            if not attention_layers(eng.cfg):
                norms = recurrent_norms(eng.cfg)
                assert paths[label]["rmsnorm"] % norms == 0, paths[label]
                log(f"  {paths[label]['rmsnorm']} RMSNorm launches: "
                    f"{norms} a model call over "
                    f"{paths[label]['rmsnorm'] // norms} model calls")
        kv_read_ratio(torch, quant["qwen3-8b"], engines["qwen3-8b"])
        seq = [(13 * i) % 251 + 1 for i in range(1024)]
        for name, eng in dense.items():
            t0 = time.perf_counter()
            (mean, gold), launches = counted(torch, lambda: eng.score(seq))
            wall = time.perf_counter() - t0
            paths[f"score {name}"] = launches
            assert math.isfinite(mean) and np.isfinite(gold).all(), name
            n_attn = attention_layers(eng.cfg)
            n_mamba = eng.cfg.block_pattern().count("mamba2")
            assert launches["flash_attention"] == n_attn, launches
            assert launches["ssm_scan"] == n_mamba, launches
            if not n_attn:
                assert launches["rmsnorm"] == recurrent_norms(eng.cfg), \
                    launches
            log(f"score [{name}] of a 1024-token sequence: {wall:.3f} s "
                f"(host clock, cold), mean logprob {mean:.4f}, {len(gold)} "
                f"tokens, flash launches {launches['flash_attention']} = "
                f"attention layers, SSD scan launches "
                f"{launches['ssm_scan']} = Mamba2 layers, RMSNorm launches "
                f"{launches['rmsnorm']}")
    assert int(finite.bad) == 0, f"{int(finite.bad)} non-finite logits"
    log("logits finite on every path")
    log(f"max memory allocated: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for path, kernel in (
            ("chunked paged pipeline", "paged_decode_attention"),
            ("chunked paged pipeline", "paged_prefill_attention_ragged"),
            ("chunked paged pipeline", "paged_prefill_attention"),
            ("int8 chunked paged pipeline", "paged_decode_attention_quant"),
            ("int8 chunked paged pipeline",
             "paged_prefill_attention_ragged_quant"),
            ("int8 chunked paged pipeline", "paged_prefill_attention_quant"),
            ("chunked paged pipeline", "ssm_scan"),
            ("dense pipeline", "decode_attention"),
            ("dense pipeline", "ssm_scan"),
            ("monolithic paged generate", "paged_decode_attention"),
            ("monolithic paged fp8 generate",
             "paged_decode_attention_quant"),
            ("zamba2 monolithic paged generate", "ssm_scan"),
            ("zamba2 monolithic paged generate", "paged_decode_attention"),
            ("score zamba2-2.7b", "ssm_scan"),
            ("score zamba2-2.7b", "flash_attention"),
            ("dense pipeline", "flash_attention"),
            ("monolithic paged generate", "flash_attention"),
            ("monolithic paged fp8 generate", "flash_attention"),
            ("zamba2 monolithic paged generate", "flash_attention")) + tuple(
                (path, "rmsnorm") for path in paths):
        assert paths[path][kernel] > 0, f"{kernel} never ran on the {path}"
    return paths, {"qwen3-8b": engines["qwen3-8b"],
                   "qwen3-8b-int8": quant["qwen3-8b"],
                   "qwen2-1.5b": engines["qwen2-1.5b"],
                   "xlstm-1.3b": xlstm,
                   "qwen3-8b-dense": dense["qwen3-8b"],
                   "zamba2-2.7b": zamba}


def xlstm_prefill(torch, eng):
    """One 256-token prompt and its first token on the paged xlstm-1.3b
    engine, eager (a first call warms up): host wall time and launches."""
    prompt = profile_prompts()[0]
    eng.generate([prompt], max_new=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, launches = counted(torch, lambda: eng.generate([prompt], max_new=1))
    wall = time.perf_counter() - t0
    assert launches["rmsnorm"] == recurrent_norms(eng.cfg), launches
    log(f"xlstm-1.3b prefill of one 256-token prompt and its first token: "
        f"{wall * 1e3:.1f} ms (host clock); RMSNorm launches "
        f"{launches['rmsnorm']} (one model call)")


def recurrent_norms(cfg):
    """RMSNorm launches of one model call of a stack without attention:
    each Mamba2, mLSTM or sLSTM layer norms its input and its inner
    activations, and the final norm runs once."""
    return 2 * cfg.n_layers + 1


def attention_layers(cfg):
    """Attention blocks a model call runs (a MoE block's attention, a
    hybrid's shared block once per application)."""
    return sum(k in ("attn", "moe", "shared_attn")
               for k in cfg.block_pattern())


def state_bytes(eng, kinds=None):
    """Bytes of an engine's recurrent state leaves, in the segments of the
    block `kinds` (default every recurrent kind)."""
    from repro_torch.models import transformer
    kinds = kinds or tuple(transformer.RECURRENT_KINDS)
    return sum(leaf.numel() * leaf.element_size()
               for (kind, _), seg in zip(transformer.segments_of(eng.cfg),
                                         eng.cache["segments"])
               if kind in kinds for leaf in seg.values())


def kv_read_ratio(torch, quant, ref):
    """KV bytes the int8 engine reads against the bf16 engine on the same
    requests and the same schedule (phase 6's batch, no stop at EOS, so
    both touch the same pages): 0.45-0.55, scales included."""
    read = []
    for eng in (quant, ref):
        eos, eng.eos_id = eng.eos_id, -1
        before = eng.kv_bytes_read
        try:
            eng.generate(profile_prompts(), max_new=32)
        finally:
            eng.eos_id = eos
        read.append(eng.kv_bytes_read - before)
    ratio = read[0] / read[1]
    log(f"kv_bytes_read on one batch (4 x 256-token prompts, 32 new "
        f"tokens): int8 {read[0]} B, bf16 {read[1]} B, ratio {ratio:.4f}")
    assert 0.45 <= ratio <= 0.55, f"int8 reads {ratio:.3f}x the bf16 bytes"


MATMUL_KERNELS = ("nvjet", "gemm", "gemv", "cutlass", "xmma")
# the float32 routes of #7b and #10b: a bf16 training step never runs them
SCALAR_BWD_KERNELS = ("bwd_dkdv_kernel", "bwd_dq_kernel", "bwd_rowdot",
                      "bwd_reduce_heads", "rmsnorm_bwd_kernel",
                      "rmsnorm_bwd_reduce")
# the device functions of csrc/*.cu, as the profiler names them (a name
# also matches the keys of the functions it is a prefix of)
PORT_KERNELS = ("decode_kernel_mma", "decode_kernel",
                "paged_prefill_kernel_mma", "paged_prefill_kernel",
                "flash_kernel_wgmma", "flash_kernel", "ssd_kernel_mma",
                "rmsnorm_kernel") + (
    # the backward kernels (training): bf16 flash and RMSNorm, the float32
    # routes' scalar kernels, and the SSD scan's (chunked, on the tensor
    # cores, since PR 26)
    "bwd_dkdv_wgmma", "bwd_dq_wgmma", "bwd_sum_clusters",
    "rmsnorm_bwd_rows") + SCALAR_BWD_KERNELS + ("ssd_bwd_mma",
                                               "ssd_bwd_sum")


def port_kernel_times(kernels):
    """{device function: (ms, launches)} of the port's kernels among the
    profiler's (key, ms, count) rows, by the function's name in the key
    (its template instances summed)."""
    out = {}
    for key, ms, n in kernels:
        if not any(k in key for k in PORT_KERNELS):
            continue
        name = re.search(r"(\w+)[<(]", key).group(1)
        t, c = out.get(name, (0.0, 0))
        out[name] = (t + ms, c + n)
    return out


def matmul_weight_bytes(cfg, params):
    """Bytes a model call's matmuls must read at least once: every matrix
    of the layers (a hybrid's shared block once per application: it does
    not fit in L2) and the unembedding matrix. The token-embedding table is
    left out where it is untied: a call gathers only a few of its rows.
    Mamba2's conv weights (K x inner) count too; they are 0.1 % of a
    layer."""
    layers = [t for seg in params["segments"] for layer in seg
              for t in _leaves(layer) if t.dim() >= 2]
    if "shared" in params:
        n = cfg.block_pattern().count("shared_attn")
        layers += [t for t in _leaves(params["shared"]) if t.dim() >= 2] * n
    emb = params["embed"]
    out = emb["tok"] if cfg.tie_embeddings else emb["unembed"]
    return sum(t.numel() * t.element_size() for t in layers + [out])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# New tokens of each engine's profiled batch in phases 6 and 10: the rows
# earlier PRs measured at 32 run 8 (the profiler's trace processing, about
# a minute an engine at 32, kept the script inside its time); zamba2's and
# xlstm's trace processing took 50-80 s each at 32.
PROFILE_DEPTH = {"qwen3-8b-int8": 8, "qwen2-1.5b": 8, "qwen3-8b-dense": 8,
                 "zamba2-2.7b": 8, "xlstm-1.3b": 8}
# Prompt length of each engine's profiled batch where it is not 256: the
# sLSTM scan launches about 17 kernels a token and layer, and the
# profiler's trace processing of 4 x 256 prompts (about 100 k launches)
# would take minutes.
PROFILE_PROMPT = {"xlstm-1.3b": 64}


def phase_profile(torch, engines):
    """Where an engine's time goes (the bf16 and int8 pools of the chunked
    qwen3-8b engine side by side): 4 requests of a 256-token prompt and
    32 new tokens (PROFILE_DEPTH for the earlier rows), timed on the host
    clock without the profiler, then the same run under torch.profiler for
    device time by kernel (`profile_run`). Returns each engine's numbers,
    which phase 10 sets beside its warmed engines'."""
    log("== phase 6: where the time goes (4 x 256-token prompts, 32 new "
        "tokens each unless a row says otherwise)")
    rows = {}
    for name, eng in engines.items():
        plen = PROFILE_PROMPT.get(name, 256)
        eng.generate(profile_prompts(plen), max_new=4)       # warm up
        rows[name] = profile_run(torch, name, eng,
                                 PROFILE_DEPTH.get(name, 32), plen)
    return rows


# host calls that launch device work: kernels (the decode kernel's cluster
# launches go through cudaLaunchKernelEx, the library matmuls' through
# cuLaunchKernelEx) and captured graphs
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")


def profile_run(torch, name, eng, new, plen=256):
    """Phase 6's batch (prompts of `plen` tokens) through `eng`, timed on
    the host clock without the profiler, then under torch.profiler for
    device time by kernel. Busy share = device time / unprofiled wall time
    (one stream, so kernels do not overlap). The matmuls' bound is their
    weight bytes, read once per model call, over the HBM rate; model calls
    = attention-kernel launches of the profiled run / attention layers (a
    monolithic prefill launches the flash kernel once a layer; a graph
    replay adds its launches to the counters), or for a stack without
    attention RMSNorm launches / `recurrent_norms`. A recurrent engine's
    decode also reads and writes every slot's state each step, logged
    beside its row. Returns {"wall_ms",
    "device_ms", "calls", "launch_calls"}: the launch calls are every
    `LAUNCH_CALLS` call of the profiled run."""
    from torch.profiler import ProfilerActivity, profile
    counters = kernel_counters()
    prompts = profile_prompts(plen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(prompts, max_new=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(prompts, max_new=new)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    averages = prof.key_averages()
    if attention_layers(eng.cfg):
        calls = sum(counters[k].launches for k in ATTENTION_KERNELS) \
            / attention_layers(eng.cfg)
    else:
        calls = counters["rmsnorm"].launches / recurrent_norms(eng.cfg)
    # device-side events only (kernels, copies, memsets): the host ops
    # that launched them repeat the same device time
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(ms for _, ms, _ in kernels)
    log(f"{name} ({plen}-token prompts, {new} new tokens): wall "
        f"{wall * 1e3:.1f} ms, device "
        f"busy {device_ms:.1f} ms ({100 * device_ms / (wall * 1e3):.1f} "
        f"%), {len(kernels)} kernel kinds; the profiled run took "
        f"{t2 - t1:.1f} s, its averages {time.perf_counter() - t2:.1f} s")
    port_ms = sum(ms for key, ms, _ in kernels
                  if any(k in key for k in PORT_KERNELS))
    by_name = ", ".join(f"{name} {ms:.3f} ms x{n}" for name, (ms, n)
                        in port_kernel_times(kernels).items())
    log(f"  the port's kernels: {port_ms:.1f} ms "
        f"({100 * port_ms / max(device_ms, 1e-9):.1f} % of device time): "
        f"{by_name}")
    if eng.recurrent:
        st = state_bytes(eng)
        log(f"  recurrent decode: {st} B of recurrent state over "
            f"{eng.max_batch} slots, read and written each step (at "
            f"least {2 * st / HBM_BYTES_PER_S * 1e3:.3f} ms a step); "
            f"SSD scan launches {counters['ssm_scan'].launches}")
    mm_ms = sum(ms for key, ms, _ in kernels
                if any(m in key for m in MATMUL_KERNELS))
    wbytes = matmul_weight_bytes(eng.cfg, eng.params)
    mm_bound = calls * wbytes / HBM_BYTES_PER_S * 1e3
    log(f"  matmul kernels: {mm_ms:.1f} ms "
        f"({100 * mm_ms / max(device_ms, 1e-9):.1f} % of device time) over "
        f"{calls:.0f} model calls; bound {mm_bound:.1f} ms "
        f"({wbytes / 1e9:.3f} GB of weights per call), "
        f"{100 * mm_bound / max(mm_ms, 1e-9):.1f} % of it")
    for key, ms, n in sorted(kernels, key=lambda k: -k[1])[:8]:
        log(f"  {ms:9.3f} ms {100 * ms / device_ms:5.1f} % x{n:<6d} "
            f"{key[:90]}")
    # the host side of the same run (the profiler slows it; the split
    # between ops is what it shows)
    host = [(e.key, e.self_cpu_time_total / 1e3, e.count)
            for e in averages
            if e.device_type == torch.autograd.DeviceType.CPU]
    host_ms = sum(ms for _, ms, _ in host)
    log(f"  host ops: {host_ms:.1f} ms self CPU time in "
        f"{sum(n for *_, n in host)} calls under the profiler")
    launches = sum(n for key, _, n in host if key == "cudaLaunchKernel")
    every = sum(n for key, _, n in host if key.startswith(LAUNCH_CALLS))
    graphs = sum(n for key, _, n in host if key == "cudaGraphLaunch")
    log(f"  cudaLaunchKernel: {launches} calls, "
        f"{launches / calls:.0f} a model call; every launch call "
        f"(cudaLaunchKernel*, cuLaunchKernel*, cudaGraphLaunch): {every}, "
        f"{every / calls:.1f} a model call; cudaGraphLaunch {graphs}")
    for key, ms, n in sorted(host, key=lambda k: -k[1])[:6]:
        log(f"  {ms:9.3f} ms {100 * ms / host_ms:5.1f} % x{n:<6d} "
            f"{key[:90]}")
    return {"wall_ms": wall * 1e3, "device_ms": device_ms, "calls": calls,
            "launch_calls": every}


# Phase 7: 4 requests of a 384-token prompt and 128 new tokens need 16
# pages of 32 each at the end, 64 in all; the tight pool holds 40.
EVICT_PROMPT, EVICT_NEW, EVICT_PAGES = 384, 128, 40
SERIAL_NEW = 32          # the serial scheduler's run (2 of the requests)
# Phase 8: a 256-token prompt evicted after 64, 256 and 768 generated
# tokens (contexts of 320, 512 and 1,024), each cycle timed 3 times.
SWAP_PROMPT, SWAP_GENERATED, SWAP_REPS = 256, (64, 256, 768), 3
# Phase 9: 16 requests of 350-450 prompt tokens and 32-64 new ones at 16
# a second on 4 slots over the tight pool: 3 in flight outgrow 40 pages.
LOAD_RATE, LOAD_PROMPT, LOAD_NEW = 16.0, (350, 450), (32, 64)
# the decode and ingest wrappers each pool's engines run
EVICT_KERNELS = {
    "": ("paged_decode_attention", "paged_prefill_attention_ragged",
         "paged_prefill_attention"),
    "int8": ("paged_decode_attention_quant",
             "paged_prefill_attention_ragged_quant",
             "paged_prefill_attention_quant")}


def restore_checker(torch, eng, checked):
    """Wrap `eng._admit_swapped`: after each promote, read back the promoted
    pages of every attention leaf (K/V codes and scale rows) and require
    them byte for byte equal to the host snapshot (uint8 views, so an int8
    or bf16 page compares its raw bytes). Appends the pages checked."""
    from repro_torch.models import transformer
    real = eng._admit_swapped

    def admit(r):
        idx = list(eng.alloc.hosted[r.req_id]["swapped_idx"])
        host = eng._swap_payloads(r.swap["host"], r.swap["pages"]) \
            if idx else []
        slot = real(r)
        if idx:
            ids = torch.tensor([eng.alloc.owned[slot][i] for i in idx],
                               device="cuda")
            segs = transformer.attention_segments(eng.cfg, eng.cache)
            for seg, snap in zip(segs, host):
                for k, leaf in seg.items():
                    back = leaf.view(torch.uint8).index_select(1, ids).cpu()
                    assert torch.equal(back, snap[k].view(torch.uint8)), \
                        f"promoted {k} differs from the host snapshot"
        checked.append(len(idx))
        return slot
    eng._admit_swapped = admit


def agreement(got, want):
    """(equal tokens, first divergence or None) of each request."""
    out = []
    for (tg, _), (tw, _) in zip(got, want):
        n = next((t for t, (a, b) in enumerate(zip(tg, tw)) if a != b), None)
        out.append((sum(a == b for a, b in zip(tg, tw)), n))
    return out


def phase_eviction(torch, params):
    """Phase 7: eviction at full width. qwen3-8b (phase 5's weights) on
    chunked paged engines, page 32, 4 slots, over a bf16 and an int8 pool:
    4 requests of a 384-token prompt and 128 new tokens (no stop at EOS) on
    a pool of 40 pages, resumed by host swap and by replay, against a roomy
    pool (4 x 32 pages), and the serial scheduler on the roomy pool (two
    of the requests, 32 new tokens). Each
    run's launches are counted from 0; every promote's pages are read back
    and held byte for byte to the host snapshot. Gates: evictions without
    any hook, swap-outs = swap-ins on the swap engines and none on the
    replay engines, every request's tokens, finite logprobs, no page in
    use and no hosted entry at the end. Greedy agreement with the roomy
    engine is reported, not gated: batch membership changes the decode
    kernel's split count at bf16, so its merge order."""
    import math
    from repro_torch.configs.pice_cloud_edge import cloud_config
    from repro_torch.serving.engine import InferenceEngine
    log("== phase 7: eviction at full width (qwen3-8b, random bf16 "
        "weights)")
    cfg = cloud_config().with_(prefill_chunk=128)
    prompts = [[(11 * i + 5 * j) % 251 + 1 for j in range(EVICT_PROMPT)]
               for i in range(4)]
    kw = dict(max_batch=4, max_len=1024, page_size=32, eos_id=-1,
              device="cuda")
    paths = {}
    for kv in ("", "int8"):
        pool = kv or "bf16"
        outs = {}
        for label, extra in (
                ("roomy", {}),
                ("swap", dict(n_pages=EVICT_PAGES)),
                ("replay", dict(n_pages=EVICT_PAGES, host_swap=False)),
                ("serial", dict(ragged_ingest=False))):
            eng = InferenceEngine(cfg.with_(kv_dtype=kv), params,
                                  name=f"{pool} {label}", **kw, **extra)
            checked = []
            if eng.host_swap:
                restore_checker(torch, eng, checked)
            # the serial scheduler runs for its launches (#3 / #5) and
            # its agreement: two of the requests and SERIAL_NEW tokens
            # keep phase 7 inside its time (the step count, not the batch,
            # sets a run's time)
            mine = prompts[:2] if label == "serial" else prompts
            new = SERIAL_NEW if label == "serial" else EVICT_NEW
            t0 = time.perf_counter()
            out, launches = counted(
                torch, lambda: eng.generate(mine, max_new=new))
            wall = time.perf_counter() - t0
            outs[label] = out
            name = f"eviction {pool} {label}"
            paths[name] = launches
            assert all(len(t) == new for t, _ in out), \
                f"{name}: a request ended short of its tokens"
            assert all(math.isfinite(x) for _, lps in out for x in lps), \
                f"{name}: non-finite logprobs"
            assert eng.alloc.pages_in_use == 0 and not eng.alloc.hosted, \
                f"{name}: pages left in use"
            if "n_pages" in extra:
                assert eng.evictions > 0, f"{name}: nothing was evicted"
            if label == "swap":
                assert eng.swap_outs > 0 and eng.swap_ins == eng.swap_outs
                assert len(checked) == eng.swap_ins
            else:
                assert eng.swap_outs == 0, f"{name}: swapped"
            decode, ragged, single = EVICT_KERNELS[kv]
            assert launches[decode] > 0 and launches["rmsnorm"] > 0
            assert launches[single if label == "serial" else ragged] > 0, \
                f"{name}: its ingest kernel never ran"
            log(f"{name}: {eng.n_pages} pages, {len(mine)} x "
                f"{EVICT_PROMPT}-token prompts, {new} new tokens each, in "
                f"{wall:.2f} s; "
                f"evictions {eng.evictions}, swap-outs {eng.swap_outs}, "
                f"swap-ins {eng.swap_ins}, swap bytes {eng.swap_bytes}, "
                f"pages read back equal to the snapshot {sum(checked)} in "
                f"{len(checked)} promotes, peak pages {eng.peak_pages}")
            del eng
        for label in ("swap", "replay", "serial"):
            log(f"  {pool} {label} against roomy (equal tokens, first "
                f"divergence) per request: "
                f"{agreement(outs[label], outs['roomy'])}")
    log("eviction-path launches: " + json.dumps(
        {name: {k: n for k, n in launches.items() if n}
         for name, launches in paths.items()}))
    return paths


def swap_cycle(torch, eng, prompt, g, swap):
    """One evict / resume of a request holding `prompt` + g generated
    tokens (the generated tokens are carried and ingested in chunks, which
    builds the state g decode steps would), timed on the host clock around
    work that ends in a synchronize: the eviction (`swap_evict_s`), the
    promote alone, and the resume to the next committed token
    (`resume_swap_s` or `resume_replay_s`, the reference benchmark's
    definition, benchmarks/paged_engine_bench.py:_swap_cycle)."""
    eng.host_swap = swap
    carry = [(7 * i) % 251 + 1 for i in range(g)]
    slot = eng.add_request(0, prompt, max_new=g + 8, carry_tokens=carry,
                           carry_lps=[0.0] * g)
    while eng.slots[slot].generated <= g:
        eng.step()
    eng._harvest()
    ctx = eng.slots[slot].ctx_len
    bytes0 = eng.swap_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    assert eng._evict_victim(protect=-1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r = eng._resume_queue.pop(0)
    assert (r.swap is not None) == swap
    n0 = len(r.carry_tokens)
    t2 = time.perf_counter()
    slot = eng.try_admit(r)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    while len(eng.slots[slot].tokens) <= n0:
        eng.step()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    assert eng.cancel(0)
    eng._harvest()
    assert eng.alloc.pages_in_use == 0 and not eng.alloc.hosted
    return {"ctx_len": ctx, "evict_s": t1 - t0, "admit_s": t3 - t2,
            "resume_s": t4 - t2, "bytes": eng.swap_bytes - bytes0}


def phase_swap_vs_replay(torch, params):
    """Phase 8: resume by promote against resume by replay at full width
    (qwen3-8b, chunked, page 32, bf16 and int8 pools), on the card's own
    clock: one request of a 256-token prompt evicted after 64, 256 and 768
    generated tokens, medians of 3 cycles after one warm cycle each way.
    Prints the points in BENCH_serving.json["swap"]'s field names (the
    file is not written), the host-link rates reached and the crossover."""
    from repro_torch.configs.pice_cloud_edge import cloud_config
    from repro_torch.serving.engine import InferenceEngine
    log("== phase 8: swap against replay at full width (qwen3-8b)")
    cfg = cloud_config().with_(prefill_chunk=128)
    prompt = [(3 * j) % 251 + 1 for j in range(SWAP_PROMPT)]
    report = {}
    for kv in ("", "int8"):
        pool = kv or "bf16"
        eng = InferenceEngine(cfg.with_(kv_dtype=kv), params, max_batch=2,
                              max_len=2048, page_size=32, n_pages=48,
                              eos_id=-1, device="cuda")
        for swap in (True, False):
            swap_cycle(torch, eng, prompt, SWAP_GENERATED[0], swap)
        points = []
        for g in SWAP_GENERATED:
            sw = [swap_cycle(torch, eng, prompt, g, True)
                  for _ in range(SWAP_REPS)]
            rp = [swap_cycle(torch, eng, prompt, g, False)
                  for _ in range(SWAP_REPS)]
            one_way = sw[0]["bytes"] // 2
            evict = statistics.median(c["evict_s"] for c in sw)
            promote = statistics.median(c["admit_s"] for c in sw)
            points.append({
                "generated": g, "ctx_len": sw[0]["ctx_len"],
                "resume_swap_s": statistics.median(c["resume_s"]
                                                   for c in sw),
                "resume_replay_s": statistics.median(c["resume_s"]
                                                     for c in rp),
                "swap_evict_s": evict, "promote_s": promote,
                "swapped_bytes_one_way": one_way,
                "device_to_host_GBps": one_way / evict / 1e9,
                "host_to_device_GBps": one_way / promote / 1e9})
            p = points[-1]
            log(f"{pool} g={g} (ctx {p['ctx_len']}): evict {evict * 1e3:.2f}"
                f" ms ({p['device_to_host_GBps']:.2f} GB/s), promote "
                f"{promote * 1e3:.2f} ms ({p['host_to_device_GBps']:.2f} "
                f"GB/s), resume by swap {p['resume_swap_s'] * 1e3:.2f} ms, "
                f"by replay {p['resume_replay_s'] * 1e3:.2f} ms, "
                f"{one_way} B one way")
        crossover = next((p["generated"] for p in points
                          if p["resume_swap_s"] < p["resume_replay_s"]),
                         None)
        report[pool] = {"kv_dtype": pool, "prompt_len": SWAP_PROMPT,
                        "points": points, "crossover_generated": crossover}
        log(f"{pool}: crossover_generated {crossover}")
        del eng
    link_probe(torch, report["bf16"]["points"][-1]["swapped_bytes_one_way"])
    log("swap: " + json.dumps(report))
    return report


def link_probe(torch, nbytes):
    """The host link alone, for `nbytes` (the largest bf16 snapshot): one
    copy each way into pageable memory (what the engine's snapshot and
    promote use) and into pinned memory, median of 5 after one warm copy,
    host clock around a synchronize."""
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    pageable = torch.empty(nbytes, dtype=torch.uint8)
    rates = {}
    for name, fn in (("device to pageable host", lambda: dev.cpu()),
                     ("device to pinned host", lambda: pinned.copy_(dev)),
                     ("pageable host to device", lambda: dev.copy_(pageable)),
                     ("pinned host to device", lambda: dev.copy_(pinned))):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rates[name] = nbytes / statistics.median(times[1:]) / 1e9
    log(f"host link, {nbytes} B: " + ", ".join(
        f"{name} {r:.2f} GB/s" for name, r in rates.items()))


def phase_loadgen(torch, params):
    """Phase 9: the load generator on the card. One seeded trace of 16
    requests at LOAD_RATE through `replay_sync` on `EngineFrontend` over
    the tight qwen3-8b bf16 pool (40 pages of 32, 4 slots, no stop at EOS),
    with host swap and with replay; tier deadlines at the load generator's
    default budget. Gates: every handle ends in a final state and no page
    is in use, no hosted entry left. Goodput, SLA attainment by tier and
    TTFT p50 / p99 are printed, not compared (walls vary between runs)."""
    from repro_torch.configs.pice_cloud_edge import cloud_config
    from repro_torch.core.profiler import RuntimeMonitor
    from repro_torch.serving import loadgen
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.frontend import EngineFrontend
    log(f"== phase 9: the load generator (qwen3-8b, {LOAD_RATE} requests a "
        f"second)")
    cfg = cloud_config().with_(prefill_chunk=128)
    trace = loadgen.synthesize_trace(LOAD_RATE, 16, seed=0,
                                     prompt_len=LOAD_PROMPT,
                                     max_new=LOAD_NEW)
    paths = {}
    for label, swap in (("host swap", True), ("replay", False)):
        eng = InferenceEngine(cfg, params, max_batch=4, max_len=1024,
                              page_size=32, n_pages=EVICT_PAGES, eos_id=-1,
                              host_swap=swap, device="cuda")
        mon = RuntimeMonitor()
        fe = EngineFrontend(eng, monitor=mon)
        handles = []
        submit = fe.submit

        def keep(req, sheddable=True, _submit=submit):
            handles.append(_submit(req, sheddable=sheddable))
            return handles[-1]
        fe.submit = keep
        rep, launches = counted(torch, lambda: loadgen.replay_sync(
            fe, trace, seed=0, offered_rps=LOAD_RATE))
        paths[f"loadgen {label}"] = launches
        states = [h.state for h in handles]
        assert len(handles) == 16 and all(
            st in ("done", "cancelled", "shed", "failed") for st in states), \
            f"loadgen {label}: handles not final: {states}"
        assert eng.alloc.pages_in_use == 0 and not eng.alloc.hosted, \
            f"loadgen {label}: pages left in use"
        assert launches["paged_decode_attention"] > 0
        tiers = {t: f"{rep.per_tier_met.get(t, 0)}/{n}"
                 for t, n in sorted(rep.per_tier_total.items())}
        log(f"loadgen {label}: {rep.n_requests} requests in "
            f"{rep.elapsed_s:.2f} s, completed {rep.completed}, deadline "
            f"{rep.deadline_cancelled}, shed {rep.shed}, failed "
            f"{rep.failed}; goodput {rep.goodput_tps:.1f} tok/s, "
            f"throughput {rep.throughput_tps:.1f} tok/s, SLA attainment "
            f"{rep.sla_attainment:.3f} (met/total by tier {tiers}); TTFT "
            f"p50 {mon.ttft_percentile(50) * 1e3:.1f} ms, p99 "
            f"{mon.ttft_percentile(99) * 1e3:.1f} ms; evictions "
            f"{eng.evictions}, swap-outs {eng.swap_outs}, swap-ins "
            f"{eng.swap_ins}")
        del eng, fe
    return paths


SOURCES = {
    "paged_decode_attention": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/paged_decode_attention/kernel.py:93"),
    "paged_prefill_attention_ragged": (
        "src/repro_torch/csrc/paged_prefill_attention.cu",
        "src/repro/kernels/paged_prefill_attention/kernel.py:215"),
    "paged_prefill_attention": (
        "src/repro_torch/csrc/paged_prefill_attention.cu",
        "src/repro/kernels/paged_prefill_attention/kernel.py:100"),
    "decode_attention": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:79"),
    "paged_decode_attention_quant": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/paged_decode_attention/kernel.py:197"),
    "paged_prefill_attention_ragged_quant": (
        "src/repro_torch/csrc/paged_prefill_attention.cu",
        "src/repro/kernels/paged_prefill_attention/kernel.py:446"),
    "paged_prefill_attention_quant": (
        "src/repro_torch/csrc/paged_prefill_attention.cu",
        "src/repro/kernels/paged_prefill_attention/kernel.py:334"),
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:88"),
    "ssm_scan": (
        "src/repro_torch/csrc/ssm_scan.cu",
        "src/repro/kernels/ssm_scan/kernel.py:76"),
    "rmsnorm": (
        "src/repro_torch/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm/kernel.py:25"),
    # the backward kernels differentiate these TPU kernels' functions (the
    # JAX package has no backward kernel)
    "flash_attention_bwd": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:88"),
    "ssm_scan_bwd": (
        "src/repro_torch/csrc/ssm_scan.cu",
        "src/repro/kernels/ssm_scan/kernel.py:76"),
    "rmsnorm_bwd": (
        "src/repro_torch/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm/kernel.py:25"),
}
# Phase 10: phase 6's engines, each beside a warmed one over the same
# weight tensors (the new tokens of each are phase 6's: PROFILE_DEPTH); the
# sampled pairs generate SAMPLED_NEW tokens (depth cut to keep the phase
# inside its time)
WARMED = ("qwen3-8b", "qwen3-8b-int8", "qwen2-1.5b", "zamba2-2.7b",
          "xlstm-1.3b")
SAMPLED_NEW = 8


def decode_step_ms(torch, eng, plen, steps=16):
    """Host wall time of one decode-only step of `eng` (ms, mean of
    `steps`): phase 6's 4 prompts (of `plen` tokens) admitted and ingested
    first, then steps that launch a decode and harvest the one before; the
    requests finish after the window."""
    for i, p in enumerate(profile_prompts(plen)):
        eng.add_request(10_000 + i, p, max_new=steps + 4)
    while any(s.active and s.prefill_toks for s in eng.slots):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    while eng.step():
        pass
    return ms


def warm_engine(torch, name, eng, max_context, plen):
    """`eng.warmup()` for contexts up to `max_context` and prompts of
    `plen`: its seconds, dispatches, captured decode graphs and the device
    memory it left reserved logged. -> eng."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    count = eng.warmup(max_context=max_context, prompt_lens=(plen,))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f"{name}: warmup() {secs:.2f} s, {count} dispatches, "
        f"{len(eng._graphs)} graphs (live widths {sorted(eng._graphs)}), "
        f"{len(eng._ingest_graphs)} ingest graphs (row buckets "
        f"{sorted(eng._ingest_graphs)}), "
        f"{torch.cuda.memory_reserved() - reserved} B of device memory left "
        f"reserved (the graphs' pool, buffers and workspaces)")
    assert eng._graphs, f"{name}: warmup captured no graph"
    return eng


def warm_against_cold(torch, name, cold, warm, prompts, new):
    """`prompts` through a cold engine, then through a warmed one over the
    same weights: the same greedy tokens, logprobs within phase 4's
    tolerance (the largest difference logged), the same launches of every
    wrapper, every decode step of the warmed engine a graph replay (none
    dispatched eagerly) and, on a chunked engine with the batched ragged
    ingest, every ingest too. -> {"cold_s", "warm_s": each run's host wall
    (synchronized), "launches": the cold run's launches}."""
    from repro_torch.models import transformer
    decode = ("paged_decode_attention_quant" if cold.cfg.kv_quantized
              else "paged_decode_attention")
    t0 = time.perf_counter()
    want, n_cold = counted(torch, lambda: cold.generate(prompts, max_new=new))
    cold_s = time.perf_counter() - t0
    replays = warm.graph_replays
    ingest_replays = warm.ingest_replays
    eager, eager_ingest = [], []
    decode_sample = warm._decode_sample
    warm._decode_sample = lambda *a, **kw: (eager.append(1),
                                            decode_sample(*a, **kw))[1]
    ragged = transformer.prefill_ragged_paged
    transformer.prefill_ragged_paged = lambda *a, **kw: (
        eager_ingest.append(1), ragged(*a, **kw))[1]
    try:
        t0 = time.perf_counter()
        got, n_warm = counted(
            torch, lambda: warm.generate(prompts, max_new=new))
        warm_s = time.perf_counter() - t0
    finally:
        # the wrapper closes a reference cycle through the engine, whose
        # graphs the cyclic collector could then free during a later
        # capture, which a capture does not allow
        del warm._decode_sample
        transformer.prefill_ragged_paged = ragged
    replays = warm.graph_replays - replays
    ingest_replays = warm.ingest_replays - ingest_replays
    assert not eager, f"{name}: {len(eager)} decode steps ran eagerly"
    if warm.prefill_chunk and warm.ragged_ingest:
        assert not eager_ingest and ingest_replays > 0, \
            f"{name}: {len(eager_ingest)} ragged ingests ran eagerly"
    worst = 0.0
    for i, ((tg, lg), (tc, lc)) in enumerate(zip(got, want)):
        assert tg == tc, f"{name}: request {i}'s greedy tokens differ " \
            "warmed and cold"
        torch.testing.assert_close(torch.tensor(lg), torch.tensor(lc),
                                   rtol=1e-4, atol=1e-5)
        worst = max(worst, max(abs(a - b) for a, b in zip(lg, lc)))
    assert n_warm == n_cold, (n_warm, n_cold)
    layers = attention_layers(cold.cfg)
    assert replays > 0 and n_warm[decode] == replays * layers, \
        f"{name}: a decode step ran outside the captured graphs"
    log(f"  greedy, {new} new tokens: tokens equal, largest logprob "
        f"difference {worst:.3g}, launches equal "
        f"({ {k: n for k, n in n_warm.items() if n} }), {replays} graph "
        f"replays, {ingest_replays} ingest replays")
    return {"cold_s": cold_s, "warm_s": warm_s, "launches": n_cold}


def replay_equals_eager(torch, eng):
    """Wrap `eng._replay_ingest` so that its next call is held to the eager
    call at the rows' live width over a copy of the cache: logits of the
    live rows, every pool leaf but the scratch page, and the lengths, bit
    for bit. -> a function that undoes the wrap and returns the number of
    calls checked."""
    from repro_torch.models import transformer
    replay, checked = eng._replay_ingest, []

    def leaves(cache):
        return [cache["lengths"]] + [
            seg[k][:, :-1] for seg in transformer.attention_segments(
                eng.cfg, cache) for k in seg]

    def check(graph, toks, slots, offs, lens):
        if checked:
            return replay(graph, toks, slots, offs, lens)
        n = int((slots < eng.max_batch).sum())
        ref = _cloned(eng.cache)
        want, ref = transformer.prefill_ragged_paged(
            eng.cfg, eng.params, torch.from_numpy(toks).to(eng.device), ref,
            slots, offs, lens,
            live_pages=eng._chunk_live(int((offs + lens).max())))
        got = replay(graph, toks, slots, offs, lens)
        assert torch.equal(got[:n], want[:n]), "replayed logits differ"
        for a, b in zip(leaves(eng.cache), leaves(ref)):
            assert torch.equal(a, b), "replayed pages or lengths differ"
        checked.append(1)
        return got
    eng._replay_ingest = check

    def undo():
        del eng._replay_ingest
        return len(checked)
    return undo


def ingest_call_ms(torch, eng, rows, reps=5):
    """One batched ragged ingest call of `rows` rows on `eng` (eager on a
    cold engine, a replay on a warmed one): `rows` 1,024-token prompts
    admitted, then `reps` calls of one chunk a row, each from an idle
    device, timed on the host clock to the call's return (the launches or
    the replay) and to the device's end; no row finishes, and the requests
    are cancelled after. On a warmed engine one more call first, held bit
    for bit to the eager call (`replay_equals_eager`). -> (host ms,
    synchronized ms), medians."""
    for i in range(rows):
        eng.add_request(30_000 + i,
                        [(5 * i + j) % 251 + 1 for j in range(1024)],
                        max_new=1)
    eng._sync_table()
    if eng._ingest_graphs:
        undo = replay_equals_eager(torch, eng)
        try:
            eng._run_ingest()
        finally:
            checked = undo()
        assert checked == 1, "no ingest was replayed"
    host, full = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._run_ingest()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        full.append((time.perf_counter() - t0) * 1e3)
    eng.abort_all()
    return statistics.median(host), statistics.median(full)


INGEST_TIMED = ("qwen3-8b", "qwen2-1.5b")


def phase_graphs(torch, engines, cold_rows):
    """Phase 10: `warmup()` on the card, and a warmed engine, which replays
    a captured CUDA graph for each decode step, against a cold one. For
    each engine of WARMED (chunked paged qwen3-8b over bf16 and int8
    pools, qwen2-1.5b, monolithic paged zamba2-2.7b): the warmup's
    seconds, dispatch count, graphs and the device memory it left
    reserved; phase 6's batch on the cold engine (phase 6's) and on the
    warmed one, which must give the same greedy tokens, logprobs within
    phase 4's tolerance (the largest difference logged) and the same
    launches of every wrapper, with every decode step and every batched
    ragged ingest a replay; for qwen3-8b and qwen2-1.5b one ingest call of
    1 and 4 rows, eager and replayed (`ingest_call_ms`); a
    decode-only step's host wall time, cold and warmed; a sampled
    pair (temperature 0.8, top_k 16, one seed), cold and warmed, which must
    draw the same tokens; then the warmed engine's run profiled as phase 6
    profiles the cold one, both rows logged side by side. No decode step or
    ragged ingest of a warmed engine may dispatch eagerly."""
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.sampler import SamplerConfig
    log("== phase 10: warmed engines (the paged decode step captured as one "
        "CUDA graph per live width, the batched ragged ingest one per row "
        "bucket) against cold ones")
    for name in WARMED:
        cold = engines[name]
        new = PROFILE_DEPTH.get(name, 32)
        plen = PROFILE_PROMPT.get(name, 256)
        prompts = profile_prompts(plen)

        def make(**kw):
            return InferenceEngine(
                cold.cfg, cold.params, max_batch=cold.max_batch,
                max_len=cold.max_len, page_size=cold.page_size, name=name,
                device="cuda", **kw)

        def warmed(**kw):
            return warm_engine(torch, name, make(**kw), plen + new, plen)
        warm = warmed()
        warm_against_cold(torch, name, cold, warm, prompts, new)
        if name in INGEST_TIMED:
            for rows in (1, 4):
                c = ingest_call_ms(torch, cold, rows)
                w = ingest_call_ms(torch, warm, rows)
                log(f"  one ingest call of {rows} x {cold.prefill_chunk} "
                    f"tokens: host {c[0]:.2f} ms eager, {w[0]:.2f} ms "
                    f"replayed (bit for bit the eager call's logits, pages "
                    f"and lengths); to the device's end {c[1]:.2f} / "
                    f"{w[1]:.2f} ms, on the host clock")
        log(f"  a decode-only step (4 live slots): "
            f"{decode_step_ms(torch, cold, plen):.2f} ms cold, "
            f"{decode_step_ms(torch, warm, plen):.2f} ms warmed, on the "
            f"host clock")
        sampler = SamplerConfig(temperature=0.8, top_k=16)
        a = make(sampler=sampler, seed=11).generate(prompts,
                                                    max_new=SAMPLED_NEW)
        b = warmed(sampler=sampler, seed=11).generate(prompts,
                                                      max_new=SAMPLED_NEW)
        assert [t for t, _ in a] == [t for t, _ in b], \
            f"{name}: sampled tokens differ warmed and cold"
        log(f"  sampled (temperature 0.8, top_k 16), {SAMPLED_NEW} new "
            f"tokens: tokens equal warmed and cold")
        row = profile_run(torch, f"{name} warmed", warm, new, plen)
        c = cold_rows[name]
        log(f"  {name} cold / warmed, {new} new tokens: wall "
            f"{c['wall_ms']:.1f} / {row['wall_ms']:.1f} ms, device busy "
            f"{c['device_ms']:.1f} / {row['device_ms']:.1f} ms, busy share "
            f"{100 * c['device_ms'] / c['wall_ms']:.1f} / "
            f"{100 * row['device_ms'] / row['wall_ms']:.1f} %, launch calls "
            f"a model call {c['launch_calls'] / c['calls']:.1f} / "
            f"{row['launch_calls'] / row['calls']:.1f}")
        del warm


# ---------------------------------------------------------------------------
# backward kernels (#7b, #9b, #10b)
# ---------------------------------------------------------------------------

# largest difference over the reference gradient's largest magnitude (at
# least 1 % of the largest magnitude among the call's gradients: a gradient
# that is zero in exact arithmetic is measured against that)
GRAD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def grad_rel_err(got, want, floor=1e-30):
    scale = want.float().abs().max().clamp_min(floor)
    return float((got.float() - want.float()).abs().max() / scale)


def autograd_plain(torch, fn, inputs, couts):
    """Gradients of sum(fn(inputs) * couts) by torch.autograd through a
    plain version, on the card."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o.float() * c.float()).sum() for o, c in zip(outs, couts))
    return torch.autograd.grad(total, leaves)


def check_grads(torch, what, got, want, dtype):
    tol = GRAD_TOL[str(dtype).split(".")[-1]]
    floor = 1e-2 * max(float(b.float().abs().max()) for b in want)
    worst = 0.0
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, what
        err = grad_rel_err(a, b, floor)
        assert err <= tol, f"{what}: {err:.3g} of the gradient's scale"
        worst = max(worst, err)
    return worst


def backward_kernel_cases(torch, gen):
    """The three backward kernels through their wrappers' autograd
    Functions (or, where a wrapper's raw backward is called, directly)
    against torch.autograd through the plain versions on the card, at a
    tiny and at a full-width shape; float32 within 2e-5 and bfloat16
    within 2e-2 of each gradient's largest magnitude; each run twice,
    bitwise equal."""
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention import ref as faref
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm import ref as rref
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    kw = dict(generator=gen, device="cuda")
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        # RMSNorm: tiny; qwen2-1.5b's 2,048 rows of 1,536 (B 8 x S 256), its
        # q-norm-width rows, xLSTM's 4,096 inner norm, the widest row
        for R, D in ((37, 96), (2048, 1536), (2048 * 12, 128), (512, 4096),
                     (64, 8192)):
            x = torch.randn(R, D, **kw).to(dtype)
            scale = torch.randn(D, **kw)
            g = torch.randn(R, D, **kw).to(dtype)
            want = autograd_plain(torch, lambda a, s: rref.rmsnorm_ref(a, s),
                                  (x, scale), (g,))
            xl, sl = x.clone().requires_grad_(True), \
                scale.clone().requires_grad_(True)
            out = rops.rmsnorm(xl, sl)
            assert out.grad_fn is not None
            got = torch.autograd.grad(out, (xl, sl), g)
            worst = check_grads(torch, f"rmsnorm_bwd {R}x{D} {dtype}", got,
                                want, dtype)
            again = rops.rmsnorm_bwd(x, scale, g)
            assert all(torch.equal(a, b) for a, b in
                       zip(again, rops.rmsnorm_bwd(x, scale, g)))
            log(f"rmsnorm_bwd R={R} D={D} {dtype}: {worst:.3g} of scale, "
                f"repeat bitwise equal")
            n += 1
        # flash: tiny GQA, q_per_kv 6 (qwen2-1.5b) and 1 (zamba2, head_dim
        # 80), with and without window and softcap; then whisper-tiny's
        # training shapes: its decoder (B 8 x S 256, 6 heads of 64, causal
        # and not) and its encoder (S 1,500, not causal); internvl2-2b's
        # (B 4 x S 512, 16 query over 8 KV heads of 128, causal)
        shapes = [(2, 37, 4, 4, 32), (1, 70, 6, 1, 24), (8, 256, 12, 2, 128),
                  (2, 256, 32, 32, 80)]
        cases = []
        for B, S, Hq, Hkv, hd in shapes:
            for causal, window, softcap in ((True, 0, 0.0), (True, 64, 0.0),
                                            (True, 0, 30.0),
                                            (False, 0, 0.0)):
                full = B * S > 1000
                if full and (window or softcap or not causal):
                    continue
                cases.append(((B, S, Hq, Hkv, hd), (causal, window, softcap)))
        cases += [((8, 256, 6, 6, 64), (True, 0, 0.0)),
                  ((8, 256, 6, 6, 64), (False, 0, 0.0)),
                  ((8, 1500, 6, 6, 64), (False, 0, 0.0)),
                  ((4, 512, 16, 8, 128), (True, 0, 0.0))]
        if dtype == torch.bfloat16:
            # qwen3-8b's group (32 query over 8 KV heads of 128) at B 2 x S
            # 512: q_per_kv 4, one cluster of 4 a kv head
            cases.append(((2, 512, 32, 8, 128), (True, 0, 0.0)))
        for (B, S, Hq, Hkv, hd), (causal, window, softcap) in cases:
            q = torch.randn(B, S, Hq, hd, **kw).to(dtype)
            k = torch.randn(B, S, Hkv, hd, **kw).to(dtype)
            v = torch.randn(B, S, Hkv, hd, **kw).to(dtype)
            do = torch.randn(B, S, Hq, hd, **kw).to(dtype)
            mk = dict(causal=causal, window=window, softcap=softcap)
            want = autograd_plain(
                torch, lambda a, b_, c: faref.flash_attention_ref(
                    a, b_, c, **mk), (q, k, v), (do,))
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = faops.flash_attention(*leaves, **mk)
            assert out.grad_fn is not None
            got = torch.autograd.grad(out, leaves, do)
            worst = check_grads(torch, f"flash_attention_bwd {B, S, Hq, Hkv, hd} "
                                f"{mk} {dtype}", got, want, dtype)
            o, lse = faops._kernel.flash_attention_cuda(
                q, k, v, with_lse=True, **mk)
            a1 = faops.flash_attention_bwd(q, k, v, o, lse, do, **mk)
            a2 = faops.flash_attention_bwd(q, k, v, o, lse, do, **mk)
            assert all(torch.equal(a, b) for a, b in zip(a1, a2))
            log(f"flash_attention_bwd B={B} S={S} Hq={Hq} Hkv={Hkv} "
                f"hd={hd} {mk} {dtype}: {worst:.3g} of scale, repeat "
                f"bitwise equal")
            n += 1
    # the SSD scan (float32): S not a multiple of 64, TINY_EDGE_C's heads,
    # zamba2's training batch and a longer sequence, with and without an
    # initial state; zamba2's heads at 1,024 tokens (8 ranks of two
    # chunks); strong decays at zamba2's training batch, where autograd
    # runs through the plain forward at 4-row chunks (at 64 rows its exp of
    # a difference of two cumulative sums lies 1e-4 of a gradient's scale
    # from the exact gradient in float32; the kernel sums each exponent
    # over the rows it spans)
    for Bb, S, H, P, N, initial, strong in (
            (2, 37, 3, 8, 4, False, False), (1, 130, 4, 64, 16, True, False),
            (2, 256, 80, 64, 64, False, False),
            (1, 300, 80, 64, 64, True, False),
            (1, 1024, 80, 64, 64, False, False),
            (2, 256, 80, 64, 64, True, True)):
        x, dt, A, B, C, h0 = scan_inputs(torch, gen, Bb, S, H, P, N, initial,
                                         strong)
        gy = torch.randn(Bb, S, H, P, **kw)
        gs = torch.randn(Bb, H, P, N, **kw)
        chunk = 4 if strong else 64
        want = autograd_plain(
            torch, lambda *t: sref.ssd_chunked_ref(*t, chunk=chunk,
                                                   initial_state=h0),
            (x, dt, A, B, C), (gy, gs))
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
        y, st = sops.ssm_scan(*leaves, initial_state=h0)
        assert y.grad_fn is not None
        got = torch.autograd.grad((y * gy).sum() + (st * gs).sum(), leaves)
        worst = check_grads(torch, f"ssm_scan_bwd {Bb, S, H, P, N}", got,
                            want, torch.float32)
        a1 = sops.ssm_scan_bwd(x, dt, A, B, C, gy, gs, initial_state=h0)
        a2 = sops.ssm_scan_bwd(x, dt, A, B, C, gy, gs, initial_state=h0)
        assert all(torch.equal(a, b) for a, b in zip(a1, a2))
        log(f"ssm_scan_bwd Bb={Bb} S={S} H={H} P={P} N={N} initial="
            f"{initial}{' strong decays' if strong else ''}: {worst:.3g} of "
            f"scale, repeat bitwise equal")
        n += 1
    try:
        h0 = torch.zeros(1, 2, 4, 4, device="cuda", requires_grad=True)
        sops.ssm_scan(torch.randn(1, 8, 2, 4, device="cuda",
                                  requires_grad=True),
                      torch.full((1, 8, 2), 0.1, device="cuda"),
                      -torch.ones(2, device="cuda"),
                      torch.randn(1, 8, 4, device="cuda"),
                      torch.randn(1, 8, 4, device="cuda"), initial_state=h0)
        raise AssertionError("a gradient to initial_state must raise")
    except NotImplementedError:
        log("ssm_scan: an initial_state that requires a gradient raises")
    return n


def sdpa_grad_ms(torch, q, k, v, do, flush, causal=True):
    """SDPA's backward: its forward and backward, less its forward (GQA by
    repeated kv heads, (B, H, S, hd) layout); and its backward alone on a
    retained graph, from the flushed L2 the kernel meets (the first form's
    backward finds q, k, v in L2, read there by its forward). -> (ms, cold
    ms)"""
    import torch.nn.functional as F
    rep = q.shape[2] // k.shape[2]
    qs = q.transpose(1, 2).contiguous().requires_grad_(True)
    ks = k.repeat_interleave(rep, 2).transpose(1, 2).contiguous() \
        .requires_grad_(True)
    vs = v.repeat_interleave(rep, 2).transpose(1, 2).contiguous() \
        .requires_grad_(True)
    dos = do.transpose(1, 2).contiguous()

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        torch.autograd.grad(out, (qs, ks, vs), dos)
    kept = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

    def bwd():
        torch.autograd.grad(kept, (qs, ks, vs), dos, retain_graph=True)
    return (device_ms(torch, fwd_bwd, flush) - device_ms(torch, fwd, flush),
            device_ms(torch, bwd, flush))


# #7b's timing rows: qwen2-1.5b's training step (B 8 x S 256, 12 over 2
# heads of 128), internvl2-2b's (B 4 x S 512, 16 over 8 of 128), zamba2's
# shared attention (B 2 x S 256, 32 over 32 of 80), whisper-tiny's
# decoder (B 8 x S 256, 6 over 6 of 64, not causal: the cross-attention
# shape of its training step) and its encoder (B 8 x S 1,500, not causal)
FLASH_BWD_ROWS = (("qwen2-1.5b", 8, 256, 12, 2, 128, True),
                  ("internvl2-2b", 4, 512, 16, 8, 128, True),
                  ("zamba2-2.7b", 2, 256, 32, 32, 80, True),
                  ("whisper-tiny S=256", 8, 256, 6, 6, 64, False),
                  ("whisper-tiny S=1500", 8, 1500, 6, 6, 64, False))
# #10b's: qwen2-1.5b's 2,048 rows of 1,536, zamba2's 512 of 2,560,
# internvl2-2b's 2,048 of 2,048
RMS_BWD_ROWS = (("qwen2-1.5b", 2048, 1536), ("zamba2-2.7b", 512, 2560),
                ("internvl2-2b", 2048, 2048))


def time_backward_kernels(torch, gen, flush, rows):
    """#7b at FLASH_BWD_ROWS (bf16) beside SDPA's backward (its forward
    and backward less its forward, `library_ms`; and its backward alone on
    a retained graph from a flushed L2, `library_cold_ms`); #10b at
    RMS_BWD_ROWS (bf16) beside `F.rms_norm`'s backward (the same two
    forms); #9b at zamba2's training shape (B 2, S 256,
    80 heads, P = N = 64, float32; no library call). Plain: the written-out
    backward of each `ref.py`. Bounds: each input read once, each output
    written once; #7b's operations 8 hd a kept (query, key) pair (dV, dP,
    dQ and dK) at the bf16 tensor-core rate, #10b's a few a value, #9b's
    10 P N a token and head (the gradient's carry, its read-outs into dx,
    dB and dC and the state product) at the 3xTF32 rate of its tensor-core
    products, the scalar float32 bound logged beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.flash_attention import ref as faref
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm import ref as rref
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    kw = dict(generator=gen, device="cuda")
    for label, B, S, Hq, Hkv, hd, causal in FLASH_BWD_ROWS:
        q = torch.randn(B, S, Hq, hd, **kw).to(torch.bfloat16)
        k = torch.randn(B, S, Hkv, hd, **kw).to(torch.bfloat16)
        v = torch.randn(B, S, Hkv, hd, **kw).to(torch.bfloat16)
        do = torch.randn(B, S, Hq, hd, **kw).to(torch.bfloat16)
        o, lse = faops._kernel.flash_attention_cuda(q, k, v, causal=causal,
                                                    with_lse=True)
        run = functools.partial(faops.flash_attention_bwd, q, k, v, o, lse,
                                do, causal=causal)
        plain = functools.partial(faref.flash_attention_bwd_ref, q, k, v, o,
                                  lse, do, causal=causal)
        got, want = run(), plain()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        pairs = B * Hq * (S * (S + 1) // 2 if causal else S * S)
        nbytes = 2 * (3 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
        lib, lib_cold = sdpa_grad_ms(torch, q, k, v, do, flush, causal)
        rows[("flash_attention_bwd", label)] = dict(
            shape=f"B={B} S={S} Hq={Hq} Hkv={Hkv} hd={hd} "
                  f"{'causal' if causal else 'not causal'} bfloat16",
            max_abs_err=err, ms=device_ms(torch, run, flush),
            plain_ms=device_ms(torch, plain, flush), library_ms=lib,
            library_cold_ms=lib_cold, bound=bound(nbytes, 8 * hd * pairs))
        del got, want
    for label, R, D in RMS_BWD_ROWS:
        x = torch.randn(R, D, **kw).to(torch.bfloat16)
        scale = torch.randn(D, **kw)
        g = torch.randn(R, D, **kw).to(torch.bfloat16)
        run = functools.partial(rops.rmsnorm_bwd, x, scale, g)
        plain = functools.partial(rref.rmsnorm_bwd_ref, x, scale, g)
        got, want = run(), plain()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        xl = x.clone().requires_grad_(True)
        wl = scale.to(torch.bfloat16).requires_grad_(True)

        def lib_fwd():
            with torch.no_grad():
                F.rms_norm(xl, (D,), wl, 1e-6)

        def lib_fwd_bwd():
            torch.autograd.grad(F.rms_norm(xl, (D,), wl, 1e-6), (xl, wl), g)
        kept = F.rms_norm(xl, (D,), wl, 1e-6)

        def lib_bwd():
            torch.autograd.grad(kept, (xl, wl), g, retain_graph=True)
        lib = device_ms(torch, lib_fwd_bwd, flush) - device_ms(torch, lib_fwd,
                                                               flush)
        rows[("rmsnorm_bwd", label)] = dict(
            shape=f"R={R} D={D} bfloat16", max_abs_err=err,
            ms=device_ms(torch, run, flush),
            plain_ms=device_ms(torch, plain, flush), library_ms=lib,
            library_cold_ms=device_ms(torch, lib_bwd, flush),
            bound=bound(3 * 2 * R * D + 2 * 4 * D, 8 * R * D,
                        F32_FLOPS_PER_S))
    Bb, S, H, P, N = 2, 256, 80, 64, 64
    x, dt, A, Bm, Cm, _ = scan_inputs(torch, gen, Bb, S, H, P, N)
    gy = torch.randn(Bb, S, H, P, **kw)
    gs = torch.randn(Bb, H, P, N, **kw)
    run = functools.partial(sops.ssm_scan_bwd, x, dt, A, Bm, Cm, gy, gs)
    plain = functools.partial(sref.ssd_bwd_ref, x, dt, A, Bm, Cm, gy, gs)
    got, want = run(), plain()
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    nbytes = 4 * (3 * x.numel() + 2 * dt.numel() + 2 * A.numel()
                  + 4 * Bm.numel() + gs.numel())
    flops = 10 * Bb * S * H * P * N
    scalar_ms, scalar_by = bound(nbytes, flops, F32_FLOPS_PER_S)
    log(f"ssm_scan_bwd bound inputs [zamba2-2.7b]: {nbytes} B; {flops} "
        f"flops (10.P.N a token and head); bound at scalar float32 (67 "
        f"TFLOP/s) {scalar_ms:.4f} ms ({scalar_by})")
    rows[("ssm_scan_bwd", "zamba2-2.7b")] = dict(
        shape=f"Bb={Bb} S={S} H={H} P={P} N={N} float32", max_abs_err=err,
        ms=device_ms(torch, run, flush),
        plain_ms=device_ms(torch, plain, flush, runs=3), library_ms=None,
        bound=bound(nbytes, flops, TF32X3_FLOPS_PER_S))


# ---------------------------------------------------------------------------
# phase 11: training
# ---------------------------------------------------------------------------

# the card-against-CPU runs' learning rate: Adam moves an element by about
# lr whatever its gradient's size, so an element whose gradient differs in
# sign or scale between the two devices parts by up to about 2 lr a step,
# and the loss parts with it; at 5e-4 three steps keep the losses within
# rtol 1e-4 (at 2e-3 the 4-layer zamba2's third loss parted by 2.4e-4 on
# an H100)
TRAIN_LR = 5e-4
BWD_KERNELS = ("flash_attention_bwd", "ssm_scan_bwd", "rmsnorm_bwd")
FWD_KERNELS = ("flash_attention", "ssm_scan", "rmsnorm")


def train_cfgs():
    """The small configs trained card against CPU (float32)."""
    from repro_torch.configs.pice_cloud_edge import (TINY_CLOUD, TINY_EDGE_A,
                                                     TINY_EDGE_C)
    from repro_torch.configs.registry import get_config
    return {"tiny-edge-a": TINY_EDGE_A.with_(dtype="float32"),
            "tiny-cloud": TINY_CLOUD.with_(dtype="float32"),
            "tiny-edge-c": TINY_EDGE_C.with_(dtype="float32"),
            "xlstm-4l": get_config("xlstm-1.3b").reduced().with_(
                n_layers=4, slstm_at=(0, 2), ssm_chunk=16, dtype="float32"),
            "zamba2-4l": get_config("zamba2-2.7b").reduced().with_(
                n_layers=4, dtype="float32")}


def train_batch(torch, b, dev):
    """A train step's batch on `dev` from (tokens, targets[, {name: stub
    embeddings}]) numpy arrays: whisper's enc_frames, a VLM's
    prefix_embeds."""
    batch = {"tokens": torch.from_numpy(b[0]).long().to(dev),
             "targets": torch.from_numpy(b[1]).long().to(dev)}
    for k, v in (b[2] if len(b) > 2 else {}).items():
        batch[k] = torch.from_numpy(v).to(dev)
    return batch


def train_steps_on(torch, cfg, masters, batches, n, opt_cfg, per_step=None):
    """n train steps from a copy of `masters`; -> (params, losses)."""
    from repro_torch.launch import steps
    from repro_torch.training import optimizer as topt
    from repro_torch.training import tree as tree_lib
    params = tree_lib.tree_map(lambda t: t.detach().clone(), masters)
    opt = topt.init_opt_state(params)
    step = steps.make_train_step(cfg, opt_cfg)
    dev = tree_lib.leaves(params)[0].device
    losses = []
    for i in range(n):
        batch = train_batch(torch, batches[i], dev)
        if per_step is None:
            params, opt, m = step(params, opt, batch)
        else:
            params, opt, m = per_step(step, params, opt, batch, i)
        losses.append(m["loss"])
    return params, [float(x) for x in losses]


def train_card_vs_cpu(torch, name, cfg, batches, opt_cfg):
    """Card against CPU from the same masters and batches: the first step's
    gradients leaf by leaf (within 5e-4 of each leaf's largest magnitude,
    floored at 1 % of the model's largest gradient: the recurrent stacks'
    float32 activations already differ by about 1e-4 between the two
    devices), then 3 AdamW steps: losses within rtol 1e-4, every element
    within 3 lr (Adam moves one by about lr whatever its gradient's size,
    so one whose gradient is float noise may go the other way), the whole
    update (params - masters) within 5 % in norm. The first step's aux
    term (the MoE balance loss) is logged. -> (the card's params after the
    steps, the card's masters)."""
    import numpy as np
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer
    from repro_torch.training import tree as tree_lib
    cpu = transformer.init_params(cfg, 0, device="cpu", master=True)
    card = _to(cpu, "cuda")
    grads, aux = {}, {}
    for dev, p in (("cuda", card), ("cpu", cpu)):
        _, metrics, grads[dev] = steps_lib.value_and_grad(
            cfg, tree_lib.tree_map(lambda t: t.detach().clone(), p),
            train_batch(torch, batches[0], dev))
        aux[dev] = float(metrics["aux"])
    flat_c = tree_lib.leaves(grads["cuda"])
    flat_h = tree_lib.leaves(grads["cpu"])
    top = max(float(g.abs().max()) for g in flat_h if g is not None)
    g_worst = 0.0
    for a, b in zip(flat_c, flat_h):
        if b is None:
            assert a is None
            continue
        err = float((a.cpu() - b).abs().max()) / max(
            float(b.abs().max()), 1e-2 * top)
        g_worst = max(g_worst, err)
    assert g_worst <= 5e-4, (name, g_worst)
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    got, got_l = train_steps_on(torch, cfg, card, batches, 3, opt_cfg)
    torch.cuda.synchronize()
    launches = {k: counters[k].launches for k in FWD_KERNELS + BWD_KERNELS}
    want, want_l = train_steps_on(torch, cfg, cpu, batches, 3, opt_cfg)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    far = total = 0
    worst = num = den = 0.0
    for a, b, p0 in zip(tree_lib.leaves(got), tree_lib.leaves(want),
                        tree_lib.leaves(cpu)):
        a, b = a.detach().cpu(), b.detach()
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        far += int((d > 1e-4).sum())
        total += d.numel()
        num += float(d.square().sum())
        den += float((b - p0).square().sum())
    upd = (num / den) ** 0.5
    assert worst <= 3 * TRAIN_LR and upd <= 0.05, (name, worst, upd)
    kinds = {k for k, _ in transformer.segments_of(cfg)}
    # every norm is an RMSNorm but whisper's LayerNorms (plain PyTorch)
    assert (launches["rmsnorm_bwd"] > 0) == (not cfg.use_layernorm)
    assert (launches["flash_attention_bwd"] > 0) == bool(
        kinds & {"attn", "moe", "shared_attn"})
    assert (launches["ssm_scan_bwd"] > 0) == ("mamba2" in kinds)
    log(f"{name}: first-step gradients within {g_worst:.3g} of each "
        f"leaf's scale; 3 steps card vs CPU, losses {got_l} vs {want_l} "
        f"(rtol 1e-4), params max diff {worst:.3g} "
        f"({worst / TRAIN_LR:.2f} lr), update within {upd:.4f} in norm, "
        f"{far} of {total} elements past 1e-4; launches {launches}")
    log(f"{name}: first-step aux term {aux['cuda']:.6f} on the card, "
        f"{aux['cpu']:.6f} on the CPU")
    return got, card


def phase_training(torch):
    """Card against CPU, repeatability, full width, and the launcher."""
    import numpy as np
    from repro_torch.configs.pice_cloud_edge import edge_configs
    from repro_torch.data import corpus as corpus_lib
    from repro_torch.data.pipeline import PackedDataset
    from repro_torch.models import transformer
    from repro_torch.training import optimizer as topt
    from repro_torch.training import tree as tree_lib
    log("== phase 11: training (float32 masters, the backward kernels)")
    text = corpus_lib.lm_text(400, 0)
    opt_cfg = topt.AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=3)
    # 1. card against CPU from the same masters and batches
    rep = None
    for name, cfg in train_cfgs().items():
        ds = iter(PackedDataset(text, 64, 4, 0))
        batches = [next(ds) for _ in range(3)]
        got, card = train_card_vs_cpu(torch, name, cfg, batches, opt_cfg)
        if name == "zamba2-4l":
            rep = (cfg, card, batches, got)
    # 2. repeatability: the hybrid (flash, scan and norms, forward and
    # backward) again on the card, bitwise equal
    cfg, card, batches, rep_params = rep
    again, _ = train_steps_on(torch, cfg, card, batches, 3, opt_cfg)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_lib.leaves(again), tree_lib.leaves(rep_params)))
    log("zamba2-4l: a second run on the card gives bitwise-equal params")
    # 3. full width: qwen2-1.5b (bf16 compute, f32 masters, remat as
    # configured) 5 steps of B 8 x S 256; zamba2-2.7b 2 steps of B 2 x S 256
    edges = edge_configs()
    paths = {}
    ds = iter(PackedDataset(corpus_lib.lm_text(3000, 0), 256, 8, 0))
    for name, n_steps, B in (("qwen2-1.5b", 5, 8), ("zamba2-2.7b", 2, 2)):
        cfg = edges[name]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        masters = transformer.init_params(cfg, 0, device="cuda", master=True)
        batches = []
        for _ in range(n_steps):
            tok, tgt = next(ds)
            batches.append((tok[:B], tgt[:B]))
        counters = kernel_counters()
        per_step = []

        def one(step, params, opt, batch, i):
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, opt, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            m = out[2]
            per_step.append(dict(
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                wall_s=wall, launches={k: counters[k].launches for k in
                                       FWD_KERNELS + BWD_KERNELS}))
            return out
        # the JAX launcher's schedule (`launch/train.py`: lr 1e-3, 20
        # warmup steps); a full lr from the first step overshoots at this
        # width (on an H100 the loss went 12.0, 6.9, 12.8, 6.7, 12.9)
        lr = topt.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=100)
        for c in counters.values():
            c.launches = 0
        params, losses = train_steps_on(torch, cfg, masters, batches,
                                        n_steps, lr, per_step=one)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for i, r in enumerate(per_step):
            log(f"{name} step {i + 1}: loss {r['loss']:.4f} grad_norm "
                f"{r['grad_norm']:.4f} wall {r['wall_s']:.3f} s launches "
                f"{r['launches']}")
        assert all(np.isfinite(losses)), losses
        if name == "qwen2-1.5b":
            assert losses[-1] < losses[0], f"{name} loss did not fall"
        else:
            # two steps on two batches: the loss on the first batch, before
            # (step 1's) and after both updates
            from repro_torch.launch import steps as steps_lib
            with torch.no_grad():
                after = float(steps_lib.loss_fn(
                    cfg, params, train_batch(torch, batches[0], "cuda"))[0])
            log(f"{name}: loss on its first batch {losses[0]:.4f} before "
                f"the steps, {after:.4f} after")
            assert after < losses[0], f"{name} loss did not fall"
        totals = {k: sum(r["launches"][k] for r in per_step)
                  for k in FWD_KERNELS + BWD_KERNELS}
        log(f"{name}: peak memory {peak:.2f} GiB, B={B} S=256 remat="
            f"{cfg.remat}, launches over {n_steps} steps {totals}")
        paths[f"{name} training"] = totals
        training_breakdown(torch, name, cfg, params, lr, batches[-1])
        del params, masters
    torch.cuda.empty_cache()
    # 4. the launcher: the TINY fleet trained 150 steps, then the pipeline
    paths.update(launcher_training(torch))
    return paths


def training_breakdown(torch, name, cfg, params, opt_cfg, batch):
    """One more step split into its forward (the loss, remat's saved
    inputs), backward (`torch.autograd.grad`) and AdamW on the host clock
    with a sync between them, then one step under torch.profiler: device
    time of the port's forward and backward kernels, the matmuls and the
    rest, and the host's launch calls."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps
    from repro_torch.training import optimizer as topt
    from repro_torch.training import tree as tree_lib
    opt = topt.init_opt_state(params)
    tok, tgt = batch
    dev = {"tokens": torch.from_numpy(tok).long().cuda(),
           "targets": torch.from_numpy(tgt).long().cuda()}
    flat = tree_lib.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss, _ = steps.loss_fn(cfg, params, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    for p in flat:
        p.requires_grad_(False)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    topt.adamw_update(opt_cfg, params, tree_lib.unflatten(params,
                                                          list(grads)), opt)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    walls = (t1 - t0, t2 - t1, t3 - t2)
    del grads, loss
    step = steps.make_train_step(cfg, opt_cfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, opt, dev)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(ms for _, ms, _ in kernels)
    bwd_names = PORT_KERNELS[8:]
    port_bwd = sum(ms for k, ms, _ in kernels
                   if any(b in k for b in bwd_names))
    port_fwd = sum(ms for k, ms, _ in kernels
                   if any(b in k for b in PORT_KERNELS[:8]))
    mm = sum(ms for k, ms, _ in kernels
             if any(m in k for m in MATMUL_KERNELS))
    launches = sum(e.count for e in averages
                   if any(e.key.startswith(c) for c in LAUNCH_CALLS))
    log(f"{name} step split (host clock, synced): forward "
        f"{walls[0] * 1e3:.1f} ms, backward {walls[1] * 1e3:.1f} ms, AdamW "
        f"{walls[2] * 1e3:.1f} ms; one profiled step: device busy "
        f"{device_ms:.1f} ms, matmuls {mm:.1f} ms "
        f"({100 * mm / device_ms:.1f} %), the port's forward kernels "
        f"{port_fwd:.2f} ms ({100 * port_fwd / device_ms:.1f} %), its "
        f"backward kernels {port_bwd:.2f} ms "
        f"({100 * port_bwd / device_ms:.1f} %), the rest "
        f"{device_ms - mm - port_fwd - port_bwd:.1f} ms; {launches} launch "
        f"calls")
    times = port_kernel_times(kernels)
    by_name = ", ".join(f"{n} {ms:.3f} ms x{c}" for n, (ms, c)
                        in times.items())
    log(f"  the port's kernels: {by_name}")
    if name == "zamba2-2.7b":
        # the SSD scan backpropagates through the chunked tensor-core
        # kernel and its fixed-order sum, never the scalar kernel it
        # replaced
        assert {"ssd_bwd_mma", "ssd_bwd_sum"} <= set(times), (
            f"{name}: the SSD scan's backward kernels did not run")
        old = [k for k, _, _ in kernels if "ssd_bwd_kernel" in k]
        assert not old, f"{name}: a step ran {old}"
    if cfg.dtype == "bfloat16":
        # bf16 attention and norms backpropagate on the tensor-core and
        # row kernels only, never through the float32 routes' scalar ones
        scalar = [n for n in times if n in SCALAR_BWD_KERNELS]
        assert not scalar, f"{name}: a bf16 step ran {scalar}"
        assert {"bwd_dq_wgmma", "bwd_dkdv_wgmma", "rmsnorm_bwd_rows"} <= set(
            times), f"{name}: the bf16 backward kernels did not run"
    for key, ms, n in sorted(kernels, key=lambda k: -k[1])[:10]:
        log(f"  {ms:9.3f} ms {100 * ms / device_ms:5.1f} % x{n:<6d} "
            f"{key[:90]}")


def launcher_training(torch):
    """`build_engines(train_steps=150)` on the card; each model's loss on a
    fixed batch before and after, its logged losses; the pipeline's mean
    ROUGE-1 F1 over 4 corpus requests, trained against untrained."""
    import numpy as np
    from repro_torch.core import metrics as metrics_lib
    from repro_torch.data import corpus as corpus_lib
    from repro_torch.data.pipeline import PackedDataset
    from repro_torch.launch import serve
    from repro_torch.serving.requests import Request
    from repro_torch.training import losses as losses_lib
    from repro_torch.models import transformer
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    logs = []
    t0 = time.perf_counter()
    trained, caps = serve.build_engines(train_steps=150, device="cuda",
                                        log_fn=logs.append)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k: counters[k].launches for k in FWD_KERNELS + BWD_KERNELS}
    for line in logs:
        log(f"  {line}")
    untrained, _ = serve.build_engines(train_steps=0, device="cuda")
    tok, tgt = next(iter(PackedDataset(corpus_lib.lm_text(2000, 0), 192, 8,
                                       0)))
    tok = torch.from_numpy(tok).long().cuda()
    tgt = torch.from_numpy(tgt).long().cuda()
    for name in trained:
        with torch.no_grad():
            before = losses_lib.cross_entropy(transformer.forward(
                untrained[name].cfg, untrained[name].params, tok)[0], tgt)[0]
            after = losses_lib.cross_entropy(transformer.forward(
                trained[name].cfg, trained[name].params, tok)[0], tgt)[0]
        log(f"{name}: loss on a fixed training batch {float(before):.4f} "
            f"untrained -> {float(after):.4f} after 150 steps")
        assert float(after) < float(before), f"{name}: the loss did not fall"
    log(f"the fleet trained in {train_s:.1f} s; launches {launches}")
    quality = {}
    examples = corpus_lib.corpus(4, seed=7)
    for label, engines in (("trained", trained), ("untrained", untrained)):
        pipe = serve.build_pipeline(engines, caps, log_fn=lambda s: None)
        q = []
        for ex in examples:
            resp = pipe.handle(Request(query=ex.query, category=ex.category))
            q.append(metrics_lib.rouge_1(ex.answer, resp.text)[2])
        quality[label] = float(np.mean(q))
        log(f"{label} fleet: mean ROUGE-1 F1 {quality[label]:.3f} over "
            f"{len(examples)} corpus requests")
    return {"TINY fleet launcher training (150 steps)": launches}



# ---------------------------------------------------------------------------
# phase 12: the other families at full width
# ---------------------------------------------------------------------------

# random bf16 weights from a seed; chunked paged engines as phase 5's
FAMILY_ENGINE = dict(max_batch=8, max_len=1024, page_size=32, device="cuda")
FAMILY_NEW = 32
# mixtral-8x7b's 32 layers (46.70 B parameters, 93.4 GB in bf16) do not fit
# one 80 GB card: its phase runs 16 of them at full width (47.0 GB)
MIXTRAL_LAYERS = 16
MIXTRAL_PROMPT, MIXTRAL_NEW, MIXTRAL_MAX_LEN = 4200, 64, 8192
# bf16 logprobs of the engine's tokens (monolithic prefill through the
# flash kernel, decode through the ring and the dense decode kernel)
# against teacher-forced `forward` over the same tokens (the flash kernel
# with the window): two bf16 evaluations of one function over 16 layers
MIXTRAL_LOGPROB_ATOL = 0.1


def draw_params(torch, name, cfg, seed):
    """Random bf16 weights from `seed`, drawn on the card one tensor at a
    time; their count and bytes logged. -> params."""
    from repro_torch.models import transformer
    from repro_torch.serving import engine as engine_mod
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=seed, device="cuda")
    tensors = list(engine_mod._tensors(params))
    log(f"{name}: {sum(t.numel() for t in tensors) / 1e9:.3f} B parameters "
        f"in its tensors "
        f"({sum(t.numel() * t.element_size() for t in tensors) / 1e9:.2f} "
        f"GB), drawn in {time.perf_counter() - t0:.1f} s")
    return params


def free_card(torch):
    """Collect what earlier phases left and return the card's cached blocks,
    so that the next model starts from an empty card; the peak counter
    starts anew."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"card before the next model: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved")


class MoECalls:
    """Records every MoE dispatch inside the `with` (eager calls only: a
    replayed graph runs no Python): the call's token count, its dropped
    assignments (from the keep mask) and its expert choices, read after the
    run."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []

    def __enter__(self):
        inner = self.inner = self.moe.dispatch

        def spy(cfg, top_e, C):
            plan = inner(cfg, top_e, C)
            self.calls.append((top_e.shape[0], (~plan["keep"]).sum(),
                               top_e.detach().clone()))
            return plan
        self.moe.dispatch = spy
        return self

    def __exit__(self, *exc):
        self.moe.dispatch = self.inner

    def summary(self, cfg, decode_T):
        """Per kind of model call (decode: T == decode_T; ingest or prefill:
        the rest): model calls, tokens, dropped assignments; and per decode
        step the experts its rows route to, summed over the layers."""
        n_layers = cfg.block_pattern().count("moe")
        out = {}
        for kind in ("decode", "ingest"):
            rows = [(T, int(d)) for T, d, _ in self.calls
                    if (T == decode_T) == (kind == "decode")]
            out[kind] = {"calls": len(rows) // n_layers,
                         "tokens": sum(T for T, _ in rows) // n_layers,
                         "assignments": sum(T for T, _ in rows)
                         * cfg.experts_per_token,
                         "dropped": sum(d for _, d in rows)}
        distinct = [int(e.unique().numel()) for T, _, e in self.calls
                    if T == decode_T]
        steps = max(len(distinct) // n_layers, 1)
        out["routed_experts_a_step"] = sum(distinct) / steps
        return out


def expert_bytes(cfg, n_experts):
    """Bytes of `n_experts` experts' three weight matrices in bf16."""
    return n_experts * 3 * cfg.d_model * cfg.expert_d_ff * 2


def moe_split(torch, cfg, layer, T, flush):
    """One MoE layer's device time split into its steps at T tokens (random
    bf16 inputs at the residual stream's scale, the layer's own weights):
    router and top-k, dispatch (positions, the plan, the buffer's gather),
    the expert products, the combine; each step timed alone by CUDA events
    on a flushed L2 (`device_ms`). -> {step: ms}."""
    from repro_torch.models import moe
    gen = torch.Generator(device="cuda")
    gen.manual_seed(T)
    xf = torch.randn(T, cfg.d_model, generator=gen,
                     device="cuda").to(torch.bfloat16)
    p = layer["moe"]
    C = moe.moe_capacity(T, cfg)
    top_w, top_e, _ = moe.route(cfg, p, xf)
    plan = moe.dispatch(cfg, top_e, C)
    buf = moe.expert_inputs(cfg, xf, plan)
    y = moe.experts_fwd(p, buf)
    return {"router and top-k": device_ms(
                torch, lambda: moe.route(cfg, p, xf), flush),
            "dispatch": device_ms(torch, lambda: moe.expert_inputs(
                cfg, xf, moe.dispatch(cfg, top_e, C)), flush),
            "expert products": device_ms(
                torch, lambda: moe.experts_fwd(p, buf), flush),
            "combine": device_ms(
                torch, lambda: moe.combine(y, plan, top_w), flush)}


def unembed_ms(torch, cfg, params, flush):
    """Device time of the unembedding of one decode step's 8 rows (CUDA
    events, L2 flushed) beside its byte bound: the (d_model, vocab) bf16
    weight read once."""
    from repro_torch.models.layers import unembed
    h = torch.randn(FAMILY_ENGINE["max_batch"], 1, cfg.d_model,
                    device="cuda").to(torch.bfloat16)
    ms = device_ms(torch, lambda: unembed(cfg, params["embed"], h), flush)
    nbytes = cfg.d_model * cfg.vocab_size * 2
    return ms, nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def serve_family(torch, name, cfg, params, flush):
    """Phase 6's batch (4 requests of a 256-token prompt, FAMILY_NEW new
    tokens) on a cold chunked paged engine and on a warmed one over the
    same weights (`warm_against_cold`): tokens/s, the decode step cold and
    warmed, launches. -> the cold run's launches."""
    from repro_torch.serving.engine import InferenceEngine
    prompts = profile_prompts()
    cold = InferenceEngine(cfg, params, name=name, **FAMILY_ENGINE)
    warm = warm_engine(torch, name, InferenceEngine(cfg, params, name=name,
                                                    **FAMILY_ENGINE),
                       256 + FAMILY_NEW, 256)
    r = warm_against_cold(torch, name, cold, warm, prompts, FAMILY_NEW)
    toks = len(prompts) * FAMILY_NEW
    log(f"  {name}: 4 x 256-token prompts, {FAMILY_NEW} new tokens each: "
        f"cold {r['cold_s']:.3f} s ({toks / r['cold_s']:.1f} tokens/s), "
        f"warmed {r['warm_s']:.3f} s ({toks / r['warm_s']:.1f} tokens/s), "
        f"host clock, first run of each engine")
    log(f"  {name}: a decode-only step (4 live slots): "
        f"{decode_step_ms(torch, cold, 256):.2f} ms cold, "
        f"{decode_step_ms(torch, warm, 256):.2f} ms warmed, host clock")
    return r["launches"]


def dense_family(torch, arch, seed, flush):
    """granite-3-8b or minitron-8b at full width."""
    from repro_torch.configs.registry import get_config
    free_card(torch)
    cfg = get_config(arch).with_(prefill_chunk=128)
    log(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}")
    params = draw_params(torch, arch, cfg, seed)
    with FiniteLogits(torch) as fin:
        launches = serve_family(torch, arch, cfg, params, flush)
    assert int(fin.bad) == 0, f"{arch}: {int(fin.bad)} non-finite logits"
    ms, bound_ms, nbytes = unembed_ms(torch, cfg, params, flush)
    log(f"  {arch}: logits finite ({fin.rows} rows sampled); the "
        f"unembedding of 8 decode rows {ms:.4f} ms on the device, its "
        f"{nbytes / 1e9:.3f} GB weight read once {bound_ms:.4f} ms at "
        f"3.35 TB/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return {f"{arch} chunked paged": launches}


def qwen3_moe_family(torch, flush):
    """qwen3-moe-30b-a3b at full depth and width over a bf16 and an int8
    pool: warmed against cold, drops, the MoE layer's split, the expert
    bytes a decode step reads, score(), peak memory."""
    import math
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    from repro_torch.serving.engine import InferenceEngine
    free_card(torch)
    arch = "qwen3-moe-30b-a3b"
    cfg = get_config(arch).with_(prefill_chunk=128)
    all_experts = cfg.n_layers * expert_bytes(cfg, cfg.n_experts)
    log(f"{arch}: {cfg.n_layers} layers, {cfg.n_experts} experts, top-"
        f"{cfg.experts_per_token}, expert d_ff {cfg.expert_d_ff}, capacity "
        f"factor {cfg.capacity_factor}; the experts "
        f"{all_experts / 1e9:.2f} GB")
    params = draw_params(torch, arch, cfg, 22)
    paths = {}
    with FiniteLogits(torch) as fin:
        for label, c in (("bf16 pool", cfg),
                         ("int8 pool", cfg.with_(kv_dtype="int8"))):
            paths[f"{arch} chunked paged, {label}"] = serve_family(
                torch, f"{arch} ({label})", c, params, flush)
        # drops and routed experts on one more cold run, at the config's
        # capacity factor
        eng = InferenceEngine(cfg, params, name=arch, **FAMILY_ENGINE)
        with MoECalls() as spy:
            eng.generate(profile_prompts(), max_new=FAMILY_NEW)
        torch.cuda.synchronize()
        seq = [(13 * i) % 251 + 1 for i in range(1024)]
        t0 = time.perf_counter()
        (mean, gold), launches = counted(torch, lambda: eng.score(seq))
        score_s = time.perf_counter() - t0
    assert int(fin.bad) == 0, f"{arch}: {int(fin.bad)} non-finite logits"
    assert math.isfinite(mean) and np.isfinite(gold).all()
    assert launches["flash_attention"] == cfg.n_layers, launches
    paths[f"score {arch}"] = launches
    st = spy.summary(cfg, FAMILY_ENGINE["max_batch"])
    for kind in ("decode", "ingest"):
        d = st[kind]
        log(f"  {arch} {kind} calls: {d['calls']} model calls of "
            f"{d['tokens']} tokens in all, {d['dropped']} of "
            f"{d['assignments']} expert assignments dropped "
            f"({d['dropped'] / max(d['calls'], 1):.1f} a call)")
    routed = st["routed_experts_a_step"]
    log(f"  {arch} expert weights a decode step: {all_experts / 1e9:.2f} GB "
        f"read by the batched products (every expert of every layer; "
        f"{all_experts / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s), "
        f"against {routed:.1f} experts routed by the step's 8 rows over "
        f"the {cfg.n_layers} layers, "
        f"{expert_bytes(cfg, routed) / 1e9:.2f} GB "
        f"({expert_bytes(cfg, routed) / HBM_BYTES_PER_S * 1e3:.2f} ms)")
    layer = params["segments"][0][0]
    for T, what in ((FAMILY_ENGINE["max_batch"], "a decode step's 8 rows"),
                    (4 * 128, "a ragged ingest call of 4 x 128 rows")):
        split = moe_split(torch, cfg, layer, T, flush)
        total = sum(split.values())
        log(f"  {arch} one MoE layer at {what} (T = {T}, C = "
            f"{moe.moe_capacity(T, cfg)}), device time by "
            f"step (CUDA events, L2 flushed, median of 21): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
            + f"; {total:.4f} ms a layer, {total * cfg.n_layers:.2f} ms "
            f"over the {cfg.n_layers} layers; the expert products' bytes "
            f"{expert_bytes(cfg, cfg.n_experts) / HBM_BYTES_PER_S * 1e3:.4f}"
            f" ms a layer at 3.35 TB/s")
    log(f"  {arch} score() of a 1024-token sequence: {score_s:.3f} s (host "
        f"clock, cold), mean logprob {mean:.4f}, launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    log(f"  {arch}: logits finite ({fin.rows} rows sampled); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return paths


def mixtral_family(torch):
    """mixtral-8x7b, 16 of its 32 layers at full width, on the dense
    engine: one 4,200-token prompt (bucket 8,192, past the 4,096 window)
    and 64 new tokens at capacity factor 8.0, each generated token's
    logprob held to teacher-forced `forward`; then a batch at the
    config's own 1.25, whose drops are logged."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.serving.engine import InferenceEngine
    free_card(torch)
    arch = "mixtral-8x7b"
    full = get_config(arch)
    cfg = full.with_(n_layers=MIXTRAL_LAYERS, capacity_factor=8.0)
    log(f"{arch}: {MIXTRAL_LAYERS} of its {full.n_layers} layers at full "
        f"width (the whole stack, {full.param_count() / 1e9:.2f} B "
        f"parameters by param_count(), does not fit one card), window "
        f"{cfg.sliding_window}, {cfg.n_experts} experts, top-"
        f"{cfg.experts_per_token}")
    params = draw_params(torch, arch, cfg, 23)
    eng = InferenceEngine(cfg, params, kv_backend="dense", max_batch=8,
                          max_len=MIXTRAL_MAX_LEN, device="cuda", eos_id=-1,
                          name=arch)
    ring = sum(seg[k].numel() * seg[k].element_size()
               for seg in eng.cache["segments"] for k in seg)
    prompt = [(7 * i) % (cfg.vocab_size - 1) + 1
              for i in range(MIXTRAL_PROMPT)]
    paths = {}
    with FiniteLogits(torch) as fin:
        t0 = time.perf_counter()
        [(toks, lps)], launches = counted(
            torch, lambda: eng.generate([prompt], max_new=MIXTRAL_NEW))
        wall = time.perf_counter() - t0
    assert int(fin.bad) == 0, f"{arch}: {int(fin.bad)} non-finite logits"
    assert len(toks) == MIXTRAL_NEW
    assert launches["flash_attention"] == MIXTRAL_LAYERS, launches
    assert launches["decode_attention"] >= \
        MIXTRAL_LAYERS * (MIXTRAL_NEW - 1), launches
    assert launches["decode_attention"] % MIXTRAL_LAYERS == 0, launches
    paths[f"{arch} dense, ring"] = launches
    with torch.no_grad():
        seq = torch.tensor([prompt + toks[:-1]], device="cuda")
        logits, _ = transformer.forward(cfg, params, seq)
        logp = torch.log_softmax(logits[0, len(prompt) - 1:].float(), -1)
        del logits
    want = logp.gather(-1, torch.tensor(toks, device="cuda")[:, None])[:, 0]
    diff = (torch.tensor(lps, device="cuda") - want).abs()
    top2 = logp.topk(2, dim=-1).values
    parted = [i for i, t in enumerate(toks)
              if int(logp[i].argmax()) != t]
    log(f"  {arch}: one {MIXTRAL_PROMPT}-token prompt (bucket "
        f"{min(1 << (MIXTRAL_PROMPT - 1).bit_length(), MIXTRAL_MAX_LEN)}, "
        f"past the window) and {MIXTRAL_NEW} new tokens in {wall:.2f} s "
        f"(host clock, cold), ring cache {ring / 1e9:.3f} GB for 8 slots "
        f"({ring / 8 / 1e6:.1f} MB a slot), launches "
        f"{ {k: n for k, n in launches.items() if n} }, at capacity "
        f"factor {cfg.capacity_factor} (no assignment drops, so the "
        f"engine's calls and forward's route alike whatever their token "
        f"counts)")
    log(f"  {arch}: engine logprobs against teacher-forced forward (flash "
        f"with the window) over the same {len(prompt) + len(toks) - 1} "
        f"tokens: largest difference {float(diff.max()):.4f}, mean "
        f"{float(diff.mean()):.4f} (tolerance {MIXTRAL_LOGPROB_ATOL}); the "
        f"engine's token is forward's argmax at {len(toks) - len(parted)} "
        f"of {len(toks)} positions, the others at forward's top-2 margins "
        f"{[round(float(top2[i, 0] - top2[i, 1]), 4) for i in parted]}")
    assert float(diff.max()) <= MIXTRAL_LOGPROB_ATOL, float(diff.max())
    del eng, logp
    # the config's own capacity factor: phase 6's batch on a dense engine
    own = cfg.with_(capacity_factor=full.capacity_factor)
    eng = InferenceEngine(own, params, kv_backend="dense", max_batch=8,
                          max_len=1024, device="cuda", name=arch)
    with MoECalls() as spy, FiniteLogits(torch) as fin:
        t0 = time.perf_counter()
        _, launches = counted(torch, lambda: eng.generate(
            profile_prompts(), max_new=FAMILY_NEW))
        wall = time.perf_counter() - t0
    assert int(fin.bad) == 0, f"{arch}: {int(fin.bad)} non-finite logits"
    paths[f"{arch} dense, capacity factor 1.25"] = launches
    st = spy.summary(own, 8)
    for kind in ("decode", "ingest"):
        d = st[kind]
        log(f"  {arch} at capacity factor {own.capacity_factor}, {kind} "
            f"calls: {d['calls']} model calls of {d['tokens']} tokens in "
            f"all, {d['dropped']} of {d['assignments']} expert assignments "
            f"dropped")
    log(f"  {arch}: 4 x 256-token prompts, {FAMILY_NEW} new tokens in "
        f"{wall:.2f} s (host clock, cold); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return paths


def phase_families(torch):
    """Phase 12: granite-3-8b, minitron-8b, qwen3-moe-30b-a3b and
    mixtral-8x7b (16 of 32 layers) at full width, one model on the card at
    a time, launch counters set to 0 before each path; then the reduced
    MoE configs trained card against CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import corpus as corpus_lib
    from repro_torch.data.pipeline import PackedDataset
    from repro_torch.training import optimizer as topt
    log("== phase 12: the other families at full width (random bf16 "
        "weights, one model on the card at a time)")
    flush = torch.empty(256 * 2 ** 20 // 4, dtype=torch.float32,
                        device="cuda")
    paths = {}
    for seed, arch in enumerate(("granite-3-8b", "minitron-8b")):
        paths.update(dense_family(torch, arch, 20 + seed, flush))
    paths.update(qwen3_moe_family(torch, flush))
    paths.update(mixtral_family(torch))
    del flush
    free_card(torch)
    text = corpus_lib.lm_text(400, 0)
    opt_cfg = topt.AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=3)
    for arch in ("qwen3-moe-30b-a3b", "mixtral-8x7b"):
        ds = iter(PackedDataset(text, 64, 4, 0))
        batches = [next(ds) for _ in range(3)]
        train_card_vs_cpu(torch, f"{arch} reduced",
                          get_config(arch).reduced(dtype="float32"),
                          batches, opt_cfg)
    return paths


# ---------------------------------------------------------------------------
# phase 13: the encoder-decoder and VLM families at full width
# ---------------------------------------------------------------------------

# bf16 logprobs of the decoded tokens against teacher-forced `forward` over
# the same tokens and stub inputs (mixtral's gate, phase 12)
STUB_LOGPROB_ATOL = 0.1
WHISPER_NEW, VLM_NEW = 64, 32


def prompt_batch(torch, cfg, seed):
    """8 prompts of 4, 8, ..., 32 tokens, right-padded to 32, on the card.
    -> (tokens (8, 32), lengths)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    toks = torch.randint(1, cfg.vocab_size, (8, 32), generator=gen,
                         device="cuda")
    plens = [4 * (i + 1) for i in range(8)]
    for b, n in enumerate(plens):
        toks[b, n:] = 0
    return toks, plens


def greedy_decode(torch, cfg, params, toks, plens, n_new, max_len, **extra):
    """Dense prefill of `toks` with the stub inputs, then `n_new` greedy
    decode steps through the step builders. -> (tokens (B, n_new),
    logprobs (B, n_new), the decode loop's host wall in s, launches)."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    def run():
        cache = transformer.init_cache(cfg, toks.shape[0], max_len,
                                       device="cuda")
        logits, cache = steps.make_prefill_step(cfg)(
            params, toks, cache, plens, **extra)
        decode = steps.make_decode_step(cfg)
        out, lps = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_new):
            logp = torch.log_softmax(logits.float(), -1)
            nxt = logp.argmax(-1)
            out.append(nxt)
            lps.append(logp.gather(-1, nxt[:, None])[:, 0])
            logits, cache = decode(params, nxt[:, None], cache)
        torch.cuda.synchronize()
        return (torch.stack(out, 1), torch.stack(lps, 1),
                time.perf_counter() - t0)
    with torch.no_grad():
        (gen, lps, wall), launches = counted(torch, run)
    return gen, lps, wall, launches


def teacher_forced_gap(torch, cfg, params, toks, plens, gen, lps, stub_key,
                       stub):
    """Each row's decoded logprobs against `forward` over its prompt and
    decoded tokens with its own stub input. -> (largest gap, mean gap,
    positions whose token is forward's argmax, of all)."""
    from repro_torch.models import transformer
    gaps, agree = [], 0
    n_new = gen.shape[1]
    with torch.no_grad():
        for b, n in enumerate(plens):
            seq = torch.cat([toks[b, :n], gen[b, :-1]])[None]
            logits, _ = transformer.forward(
                cfg, params, seq, **{stub_key: stub[b:b + 1]})
            logp = torch.log_softmax(logits[0, -n_new:].float(), -1)
            want = logp.gather(-1, gen[b][:, None])[:, 0]
            gaps.append((lps[b] - want).abs())
            agree += int((logp.argmax(-1) == gen[b]).sum())
    gaps = torch.cat(gaps)
    return float(gaps.max()), float(gaps.mean()), agree, gaps.numel()


def stub_train_steps(torch, name, cfg, seed, n_steps, B, S, stub_key,
                     stub_shape):
    """n_steps AdamW steps at full width on float32 masters (bf16 compute,
    remat) with a random stub input a batch: each step's loss, wall and
    forward / backward launches, the peak memory. -> {kernel: launches}
    over the steps."""
    from repro_torch.launch import steps
    from repro_torch.models import layers, transformer
    import numpy as np
    from repro_torch.training import optimizer as topt
    free_card(torch)
    masters = transformer.init_params(cfg, seed=seed, device="cuda",
                                      master=True)
    opt = topt.init_opt_state(masters)
    step = steps.make_train_step(cfg, topt.AdamWConfig(
        lr=1e-3, warmup_steps=20, total_steps=100))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    # in the compute dtype, which the encoder requires of its frames
    dtype = layers.compute_dtype(cfg)
    total = {}
    for i in range(n_steps):
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (B, S),
                                         generator=gen, device="cuda"),
                 "targets": torch.randint(1, cfg.vocab_size, (B, S),
                                          generator=gen, device="cuda"),
                 stub_key: (0.02 * torch.randn(*stub_shape, generator=gen,
                                               device="cuda")).to(dtype)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (masters, opt, m), launches = counted(
            torch, lambda: step(masters, opt, batch))
        wall = time.perf_counter() - t0
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        log(f"  {name} train step {i + 1}: loss {float(m['loss']):.4f}, "
            f"grad norm {float(m['grad_norm']):.4f}, {wall:.3f} s (host "
            f"clock), launches "
            f"{ {k: launches[k] for k in FWD_KERNELS + BWD_KERNELS} }")
        assert np.isfinite(float(m["loss"]))
    log(f"  {name} training: B {B} x S {S} tokens with {stub_key} "
        f"{tuple(stub_shape)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return total


def whisper_family(torch, flush):
    """whisper-tiny at full width: the encoder over 8 x 1,500 random bf16
    frames (its wall and #7 launches), 32-token prompts and 64 greedy
    decode steps over the dense cache held to teacher-forced `forward`,
    the cross-attention's share of a decode step, then 3 training steps of
    B 8 x S 256 with frames."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import transformer
    from repro_torch.models.layers import norm
    free_card(torch)
    arch = "whisper-tiny"
    cfg = get_config(arch)
    e = cfg.encoder
    log(f"{arch}: a {e.n_layers}-layer encoder over {e.n_ctx} frames of "
        f"{e.d_model}, a {cfg.n_layers}-layer decoder ({cfg.n_heads} heads "
        f"of {cfg.resolved_head_dim}), dec_pos {cfg.max_seq_len} x "
        f"{cfg.d_model}; {cfg.param_count() / 1e6:.1f} M parameters by "
        f"param_count()")
    params = draw_params(torch, arch, cfg, 30)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(30)
    frames = torch.randn(8, e.n_ctx, e.d_model, generator=gen,
                         device="cuda").to(torch.bfloat16)
    paths = {}
    with torch.no_grad():
        enc, launches = counted(
            torch, lambda: transformer.encode(cfg, params["encoder"], frames))
        assert launches["flash_attention"] == e.n_layers, launches
        assert torch.isfinite(enc).all()
        t0 = time.perf_counter()
        for _ in range(5):
            transformer.encode(cfg, params["encoder"], frames)
        torch.cuda.synchronize()
        enc_s = (time.perf_counter() - t0) / 5
    paths[f"{arch} encode"] = launches
    log(f"  {arch} encode of 8 x {e.n_ctx} frames: {enc_s * 1e3:.2f} ms "
        f"(host clock, mean of 5), {launches['flash_attention']} flash "
        f"launches (not causal, one an encoder layer)")
    toks, plens = prompt_batch(torch, cfg, 30)
    new, lps, wall, launches = greedy_decode(
        torch, cfg, params, toks, plens, WHISPER_NEW, 128, enc_frames=frames)
    paths[f"{arch} prefill + decode"] = launches
    assert launches["flash_attention"] == e.n_layers + cfg.n_layers
    assert launches["decode_attention"] == cfg.n_layers * WHISPER_NEW
    assert launches["rmsnorm"] == 0, "whisper's norms are LayerNorms"
    worst, mean, agree, total = teacher_forced_gap(
        torch, cfg, params, toks, plens, new, lps, "enc_frames", frames)
    log(f"  {arch}: prefill of 8 prompts of 4-32 tokens padded to 32, "
        f"{WHISPER_NEW} greedy decode steps in {wall:.3f} s "
        f"({wall / WHISPER_NEW * 1e3:.2f} ms a step, host clock, the "
        f"logprob reads included); launches "
        f"{ {k: n for k, n in launches.items() if n} }; logprobs against "
        f"teacher-forced forward: largest gap {worst:.4f}, mean {mean:.4f} "
        f"(tolerance {STUB_LOGPROB_ATOL}); the decoded token is forward's "
        f"argmax at {agree} of {total} positions")
    assert worst <= STUB_LOGPROB_ATOL, worst
    # the cross-attention's share of a decode step (CUDA events, L2
    # flushed): the 4 layers' cached cross-attention against the step
    cache = transformer.init_cache(cfg, 8, 128, device="cuda")
    with torch.no_grad():
        transformer.prefill(cfg, params, toks, cache, plens,
                            enc_frames=frames)
        nxt = toks[:, :1]
        step_ms = device_ms(torch, lambda: transformer.decode_step(
            cfg, params, nxt, cache), flush)
        x = torch.randn(8, 1, cfg.d_model, generator=gen,
                        device="cuda").to(torch.bfloat16)
        layers = [(lay, c) for _, lay, c in transformer._walk(
            cfg, params, cache)]

        def cross():
            for lay, c in layers:
                attn_lib.cross_attention_cached(
                    cfg, lay["xattn"], norm(cfg, lay["norm_x"], x),
                    c["cross_k"], c["cross_v"])
        cross_ms = device_ms(torch, cross, flush)
    cross_bytes = sum(c[k].numel() * 2 for _, c in layers
                      for k in ("cross_k", "cross_v"))
    log(f"  {arch} one decode step (8 rows) on the device: {step_ms:.4f} ms;"
        f" its {cfg.n_layers} cached cross-attentions (plain PyTorch) "
        f"{cross_ms:.4f} ms ({100 * cross_ms / step_ms:.1f} %), their "
        f"{cross_bytes / 1e6:.2f} MB of cross K/V read once "
        f"{cross_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s "
        f"(CUDA events, L2 flushed, median of 21)")
    del params, cache, enc
    launches = stub_train_steps(torch, arch, cfg, 32, 3, 8, 256,
                                "enc_frames", (8, e.n_ctx, e.d_model))
    paths[f"{arch} training"] = launches
    assert launches["flash_attention_bwd"] == 3 * (e.n_layers + cfg.n_layers)
    # the encoder's own backward: its flash backward launches, none causal
    masters = transformer.init_params(cfg, seed=32, device="cuda",
                                      master=True)
    working = transformer.cast_params(cfg, masters)
    f = frames.clone().requires_grad_(True)

    def enc_bwd():
        out = transformer.encode(cfg, working["encoder"], f)
        torch.autograd.grad(out.float().square().sum(), f)
    _, launches = counted(torch, enc_bwd)
    assert launches["flash_attention_bwd"] == e.n_layers, launches
    log(f"  {arch}: {launches['flash_attention_bwd']} of each step's "
        f"{e.n_layers + cfg.n_layers} flash backward launches "
        f"are the encoder's (not causal, S {e.n_ctx}), the rest the "
        f"decoder's (causal, S 256)")
    return paths


def internvl_family(torch, flush):
    """internvl2-2b at full width: dense prefill of 8 rows of 256 random
    patch embeddings and 32-token prompts, 32 greedy decode steps held to
    teacher-forced `forward`; the text-only chunked paged engine on phase
    6's batch, cold and warmed; 2 training steps of B 4 x (256 patches +
    256 tokens)."""
    from repro_torch.configs.registry import get_config
    free_card(torch)
    arch = "internvl2-2b"
    cfg = get_config(arch).with_(prefill_chunk=128)
    n = cfg.n_prefix_tokens
    log(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} over {cfg.n_kv_heads} heads, {n} patch embeddings, "
        f"vocabulary {cfg.vocab_size}; {cfg.param_count() / 1e9:.3f} B "
        f"parameters by param_count()")
    params = draw_params(torch, arch, cfg, 31)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    # stub patch embeddings at the token embeddings' scale (std 0.02)
    patches = (0.02 * torch.randn(8, n, cfg.d_model, generator=gen,
                                  device="cuda")).to(torch.bfloat16)
    toks, plens = prompt_batch(torch, cfg, 31)
    paths = {}
    with FiniteLogits(torch) as fin:
        new, lps, wall, launches = greedy_decode(
            torch, cfg, params, toks, plens, VLM_NEW, n + 32 + VLM_NEW,
            prefix_embeds=patches)
        paths[f"{arch} dense prefill + decode"] = launches
        assert launches["flash_attention"] == cfg.n_layers
        assert launches["decode_attention"] == cfg.n_layers * VLM_NEW
        worst, mean, agree, total = teacher_forced_gap(
            torch, cfg, params, toks, plens, new, lps, "prefix_embeds",
            patches)
        log(f"  {arch}: prefill of 8 rows of {n} patches + 4-32 tokens "
            f"(padded to 32), {VLM_NEW} greedy decode steps in {wall:.3f} s "
            f"({wall / VLM_NEW * 1e3:.2f} ms a step, host clock); launches "
            f"{ {k: c for k, c in launches.items() if c} }; logprobs "
            f"against teacher-forced forward: largest gap {worst:.4f}, mean "
            f"{mean:.4f} (tolerance {STUB_LOGPROB_ATOL}); forward's argmax "
            f"at {agree} of {total} positions")
        assert worst <= STUB_LOGPROB_ATOL, worst
        paths[f"{arch} chunked paged (text only)"] = serve_family(
            torch, arch, cfg, params, flush)
    assert int(fin.bad) == 0, f"{arch}: {int(fin.bad)} non-finite logits"
    log(f"  {arch} serving: logits finite ({fin.rows} rows sampled); peak "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del params
    paths[f"{arch} training"] = stub_train_steps(
        torch, arch, cfg, 33, 2, 4, 256, "prefix_embeds", (4, n, cfg.d_model))
    return paths


def phase_stub_families(torch):
    """Phase 13: whisper-tiny and internvl2-2b at full width, random bf16
    weights and stub inputs from a seed, one model on the card at a
    time."""
    log("== phase 13: the encoder-decoder and VLM families at full width")
    flush = torch.empty(256 * 2 ** 20 // 4, dtype=torch.float32,
                        device="cuda")
    paths = whisper_family(torch, flush)
    paths.update(internvl_family(torch, flush))
    del flush
    return paths


# ---------------------------------------------------------------------------
# phase 14: the §IV-D fine-tuning pipeline
# ---------------------------------------------------------------------------

def _logged_losses(lines):
    return [float(re.search(r"loss=([0-9.]+)", s).group(1)) for s in lines
            if "loss=" in s]


def masters_card_vs_cpu(name, got, want, start, lr, steps):
    """Phase 11's gates on masters trained on the card and on the CPU from
    the same `start`: every element within `steps` x lr (Adam moves one by
    about lr a step whatever its gradient's size; phase 11 gates 3 steps at
    3 lr), the whole update (masters - start) within 5 % in norm."""
    from repro_torch.training import tree as tree_lib
    worst = num = den = 0.0
    for a, b, p0 in zip(tree_lib.leaves(got), tree_lib.leaves(want),
                        tree_lib.leaves(start)):
        a, b = a.detach().cpu(), b.detach()
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        num += float(d.square().sum())
        den += float((b - p0).square().sum())
    upd = (num / den) ** 0.5
    assert worst <= steps * lr and upd <= 0.05, (name, worst, upd)
    log(f"{name}: masters card vs CPU max diff {worst:.3g} "
        f"({worst / lr:.2f} lr over {steps} steps), update within "
        f"{upd:.4f} in norm")


def tiny_finetune(torch):
    """The JAX example's pipeline on TINY_CLOUD in float32: SFT (20 steps)
    and the reward model (20 steps) on the card and on the CPU from the
    same CPU-drawn masters and the same batches, the trained masters within
    phase 11's gates (`masters_card_vs_cpu`) and the logged losses within
    its rtol 1e-4; `label_pair` on 8 corpus examples through an SFT engine
    on the card; RLAIF 3 steps at batch 2 twice on the card."""
    import numpy as np
    from repro_torch.configs.pice_cloud_edge import TINY_CLOUD
    from repro_torch.data import corpus as corpus_lib
    from repro_torch.data import tokenizer as tok
    from repro_torch.finetune import reward_model as rm_lib
    from repro_torch.finetune.preference import label_pair
    from repro_torch.finetune.rlaif import RLAIFConfig, run_rlaif
    from repro_torch.finetune.sft import run_sft
    from repro_torch.models import transformer
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_loop
    from repro_torch.training import tree as tree_lib
    cfg = TINY_CLOUD.with_(dtype="float32")

    def copy_to(tree, dev):
        return tree_lib.tree_map(lambda t: t.detach().clone().to(dev), tree)
    start = train_loop.init_train_state(cfg, 0, device="cpu").params
    states, logs = {}, {}
    for dev in ("cuda", "cpu"):
        p = copy_to(start, dev)
        st = train_loop.TrainState(params=p, opt_state=topt.init_opt_state(p))
        logs[dev] = []
        t0 = time.perf_counter()
        states[dev] = run_sft(cfg, n_steps=20, state=st,
                              log_fn=logs[dev].append)
        log(f"tiny-cloud SFT on {dev}: 20 steps of 8 x 192 in "
            f"{time.perf_counter() - t0:.2f} s: {logs[dev]}")
    np.testing.assert_allclose(_logged_losses(logs["cuda"]),
                               _logged_losses(logs["cpu"]), rtol=1e-4)
    masters_card_vs_cpu("tiny-cloud SFT, 20 steps", states["cuda"].params,
                        states["cpu"].params, start, 1e-3, 20)
    params = states["cuda"].params
    engine = InferenceEngine(cfg, transformer.serving_params(cfg, params),
                             max_batch=4, max_len=768, kv_backend="dense",
                             device="cuda")

    def expand(x, r):
        (out, _), = engine.generate(
            [tok.encode(f"Q: {x[:80]}\nS: {r}\nE:")], max_new=96)
        return tok.decode(out)
    t0 = time.perf_counter()
    triples = [label_pair(ex.answer[:160], ex.answer, ex.sketch,
                          ex.answer[: 2 * len(ex.sketch)], expand)
               for ex in corpus_lib.corpus(8, seed=9)]
    log(f"tiny-cloud: labeled {len(triples)} pairs through the SFT engine in "
        f"{time.perf_counter() - t0:.2f} s (concise sketch preferred in "
        f"{sum(t.r_w != t.x for t in triples)}; scores "
        f"{[round(t.score_w - t.score_l, 3) for t in triples]})")
    # both devices start from the CPU's draw: the card's own generator
    # (Philox) would give other weights than the CPU's (MT19937)
    rm_start = rm_lib.init_reward_model(cfg, 0, "cpu")
    drawn = rm_lib.init_reward_model
    rms = {}
    try:
        rm_lib.init_reward_model = \
            lambda cfg_, seed, device: copy_to(rm_start, device)
        for dev in ("cuda", "cpu"):
            logs[dev] = []
            rms[dev] = rm_lib.train_reward_model(cfg, triples, n_steps=20,
                                                 device=dev,
                                                 log_fn=logs[dev].append)
    finally:
        rm_lib.init_reward_model = drawn
    np.testing.assert_allclose(_logged_losses(logs["cuda"]),
                               _logged_losses(logs["cpu"]), rtol=1e-4)
    log(f"tiny-cloud reward model, 20 steps: card {logs['cuda']}, CPU "
        f"{logs['cpu']} (rtol 1e-4)")
    masters_card_vs_cpu("tiny-cloud reward model, 20 steps", rms["cuda"],
                        rms["cpu"], rm_start, 1e-3, 20)
    before = [t.clone() for t in tree_lib.leaves(params)]
    hists = []
    for _ in range(2):
        t0 = time.perf_counter()
        _, hist = run_rlaif(cfg, params, params, cfg, rms["cuda"],
                            RLAIFConfig(n_steps=3, batch=2),
                            log_fn=lambda s: None)
        hists.append(hist)
        log(f"tiny-cloud RLAIF, 3 steps at batch 2: "
            f"{time.perf_counter() - t0:.2f} s, history {hist}")
    assert hists[0] == hists[1], "one seed must give one history"
    assert hists[0][0]["kl"] == 0.0, hists[0]
    assert all(torch.equal(a, b) for a, b in
               zip(tree_lib.leaves(params), before)), "sft_params moved"
    log("tiny-cloud RLAIF: two runs equal, step 1's KL 0, the SFT params "
        "unchanged")


def qwen2_finetune(torch):
    """The pipeline at full width on qwen2-1.5b (float32 masters, bf16
    compute, remat): 2 SFT steps of 8 x 192, 2 reward-model steps of 8 x
    160, 1 RLAIF step at batch 2 with 64-token sketches; each part's wall,
    launches and peak memory. The SFT optimizer state is freed before the
    reward model, whose own is freed on return. -> {path: launches}."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.data import corpus as corpus_lib
    from repro_torch.finetune import reward_model as rm_lib
    from repro_torch.finetune.preference import PreferenceTriple
    from repro_torch.finetune.rlaif import RLAIFConfig, run_rlaif
    from repro_torch.finetune.sft import run_sft
    free_card(torch)
    arch = "qwen2-1.5b"
    cfg = get_config(arch)
    paths = {}

    def part(label, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, launches = counted(torch, fn)
        wall = time.perf_counter() - t0
        paths[f"{arch} {label}"] = launches
        log(f"  {arch} {label}: {wall:.2f} s (host clock), launches "
            f"{ {k: launches[k] for k in FWD_KERNELS + BWD_KERNELS + ('decode_attention',) if launches[k]} }"
            f", peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
            f" GiB, {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held "
            f"after")
        return out
    logs = []
    state = part("SFT, 2 steps of 8 x 192", lambda: run_sft(
        cfg, n_steps=2, seq_len=192, batch=8, n_pairs=200, device="cuda",
        log_fn=logs.append))
    log(f"  {arch} SFT: {logs}")
    state.opt_state = None
    free_card(torch)
    triples = [PreferenceTriple(ex.answer[:120], ex.sketch,
                                " ".join(reversed(ex.answer.split()[:30])),
                                1.0, 0.0)
               for ex in corpus_lib.corpus(32, seed=3)]
    logs = []
    rm = part("reward model, 2 steps of 8 x 160",
              lambda: rm_lib.train_reward_model(cfg, triples, n_steps=2,
                                                device="cuda",
                                                log_fn=logs.append))
    log(f"  {arch} reward model: {logs}")
    free_card(torch)
    _, hist = part("RLAIF, 1 step at batch 2, 64-token sketches",
                   lambda: run_rlaif(cfg, state.params, state.params, cfg,
                                     rm, RLAIFConfig(n_steps=1, batch=2),
                                     log_fn=lambda s: None))
    log(f"  {arch} RLAIF: {hist}")
    assert hist[0]["kl"] == 0.0 and np.isfinite(hist[0]["mean_reward"])
    return paths


def phase_finetune(torch):
    """Phase 14: the §IV-D fine-tuning pipeline (SFT, preference labels,
    reward model, RLAIF) on TINY_CLOUD card against CPU, then on
    qwen2-1.5b at full width."""
    log("== phase 14: fine-tuning (SFT, preferences, reward model, RLAIF)")
    tiny_finetune(torch)
    return qwen2_finetune(torch)


# ---------------------------------------------------------------------------
# phase 15: the dry-run's roofline against the card
# ---------------------------------------------------------------------------

# (architecture, input shape) pairs of the dry-run that one card holds,
# each run for real: qwen3-8b at long_500k is a ring of 4,096 rows
# (`adapt_for_shape`) read by #8; zamba2-2.7b's shared attention reads its
# 524,288-row cache through #8 and its Mamba2 decode runs in plain
# PyTorch; qwen2-1.5b's ring as qwen3-8b's
ROOFLINE_PAIRS = (("qwen3-8b", "long_500k"), ("zamba2-2.7b", "long_500k"),
                  ("qwen2-1.5b", "long_500k"))
ROOFLINE_RUNS = 11
# the dry-run's peak may not lie below the card's by more than this
PEAK_SLACK = 0.10


def phase_roofline(torch):
    """Phase 15: each pair's dry-run on the host (`launch/dryrun.py`,
    h100x1: the step under fake tensors, plain path), then the same step
    on the card at full width with random bf16 weights from a seed: its
    counted flops and bytes, its roofline terms beside the median step
    time (CUDA events), the step's share of its roofline (the larger term
    over the measured time), the estimated peak against
    `torch.cuda.max_memory_allocated` less what earlier phases still hold,
    and the launches of #8 and #10. The dry-run runs the plain path,
    which the card's step does not: its bytes accessed count the plain
    path's float32 copies, so the memory term is the unique-byte bound
    (arguments read once, outputs written once), which both paths must
    move, and its peak is the plain path's (an estimate from above).
    Gates: the dry-run says the pair fits, logits are finite, the estimate
    is not below the measured peak by more than PEAK_SLACK, and #8 (where
    the stack has attention) and #10 run. -> {path: launches}."""
    from repro_torch.configs.registry import SHAPES, get_config
    from repro_torch.distributed import roofline
    from repro_torch.launch import dryrun
    log("== phase 15: the dry-run's roofline against the card")
    paths = {}
    for arch, shape_name in ROOFLINE_PAIRS:
        t0 = time.perf_counter()
        rec = dryrun.run_one(arch, shape_name, "h100x1")
        host_s = time.perf_counter() - t0
        assert rec["status"] == "ok" and rec["fits"], rec
        row = roofline.row_from_record(rec)
        free_card(torch)
        held = torch.cuda.memory_allocated()    # what earlier phases keep
        shape = SHAPES[shape_name]
        cfg = dryrun.dryrun_config(get_config(arch), shape)
        fn, args = dryrun.build_step(cfg, shape, device="cuda")
        tokens, cache = args[1], args[2]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        tokens.copy_(torch.randint(0, cfg.vocab_size, tokens.shape,
                                   generator=gen, device="cuda"))
        lengths = cache["lengths"]
        start = lengths.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, launches = counted(torch, lambda: fn(*args))
        assert torch.isfinite(out[0].float()).all(), arch
        del out                         # (logits, the cache)
        times = []
        for _ in range(ROOFLINE_RUNS):
            lengths.copy_(start)        # each step reads the whole cache
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            logits = fn(*args)[0]
            end.record()
            end.synchronize()
            times.append(begin.elapsed_time(end))
        assert torch.isfinite(logits.float()).all(), arch
        ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() - held
        est = rec["memory"]["peak_bytes"]
        terms_ms = {"compute": row.compute_s * 1e3,
                    "memory": rec["unique_bytes"] / roofline.HBM_BW * 1e3}
        bound = max(terms_ms, key=terms_ms.get)
        log(f"{arch} x {shape_name}: dry-run {host_s:.1f} s on the host; "
            f"counted {rec['flops']:.4e} flops, {rec['unique_bytes']:.4e} B "
            f"unique ({rec['bytes_accessed']:.4e} B accessed on the plain "
            f"path); roofline terms compute {terms_ms['compute']:.4f} ms, "
            f"memory {terms_ms['memory']:.4f} ms ({bound}); step on the "
            f"card {ms:.4f} ms (median of {ROOFLINE_RUNS}, CUDA events), "
            f"{100 * terms_ms[bound] / ms:.1f} % of its roofline; peak "
            f"memory estimated {est / 2 ** 30:.2f} GiB (plain path), "
            f"measured {peak / 2 ** 30:.2f} GiB, {est / peak:.3f}x; "
            f"launches #8 {launches['decode_attention']}, #10 "
            f"{launches['rmsnorm']}")
        assert est >= (1 - PEAK_SLACK) * peak, (arch, est, peak)
        assert launches["rmsnorm"] > 0, launches
        if any(kind != "mamba2" for kind in cfg.block_pattern()):
            assert launches["decode_attention"] > 0, launches
        paths[f"{arch} {shape_name} step"] = launches
        del fn, args, tokens, cache, logits, lengths, start
    free_card(torch)
    return paths


# the full-width path each kernel's `launches` is read from (phase 5)
MAIN_PATH = {"paged_decode_attention": "chunked paged pipeline",
             "paged_prefill_attention_ragged": "chunked paged pipeline",
             "paged_prefill_attention": "chunked paged pipeline",
             "paged_decode_attention_quant": "int8 chunked paged pipeline",
             "paged_prefill_attention_ragged_quant":
                 "int8 chunked paged pipeline",
             "paged_prefill_attention_quant": "int8 chunked paged pipeline",
             "decode_attention": "dense pipeline",
             "flash_attention": "dense pipeline",
             "ssm_scan": "chunked paged pipeline",
             "rmsnorm": "chunked paged pipeline",
             # the backward kernels' main path is training (phase 11)
             "flash_attention_bwd": "qwen2-1.5b training",
             "rmsnorm_bwd": "qwen2-1.5b training",
             "ssm_scan_bwd": "zamba2-2.7b training"}
# the timing rows of each kernel (phase 3): the first at the top level of
# its JSON entry, the others under their own names
DECODE_ROWS = tuple(model + suffix for suffix, _ in DECODE_SHAPES
                    for model in ("qwen3-8b", "qwen2-1.5b"))
TIMING_ROWS = {"paged_decode_attention": DECODE_ROWS,
               "paged_decode_attention_quant": DECODE_ROWS,
               "decode_attention": DECODE_ROWS,
               "ssm_scan": ("zamba2-2.7b", "zamba2-2.7b S=256"),
               "flash_attention": ("qwen3-8b", "qwen2-1.5b",
                                   "qwen3-8b B=4 S=256", WHISPER_ENCODER_ROW),
               "rmsnorm": ("qwen3-8b", "zamba2-2.7b", "qwen3-8b decode",
                           "qwen3-8b q-norm"),
               "flash_attention_bwd": tuple(r[0] for r in FLASH_BWD_ROWS),
               "rmsnorm_bwd": tuple(r[0] for r in RMS_BWD_ROWS),
               "ssm_scan_bwd": ("zamba2-2.7b",)}


# each kernel's tolerance against its plain version in the timing rows
TOLERANCES = {"ssm_scan": SCAN_TOL,
              "ssm_scan_bwd": {"relative_to_gradient_scale": 2e-5},
              "flash_attention_bwd": {"relative_to_gradient_scale": 2e-2},
              "rmsnorm_bwd": {"relative_to_gradient_scale": 2e-2}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    t_start = time.perf_counter()

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"-- {label} took {time.perf_counter() - t0:.1f} s "
            f"({time.perf_counter() - t_start:.1f} s in all)")
        return out
    smi = timed("phase 1", phase_environment, torch)
    timed("phase 2", phase_kernels_vs_plain, torch)
    timing = timed("phase 3", phase_timing, torch)
    timed("phase 4", phase_tiny_parity, torch)
    paths, engines = timed("phase 5", phase_full_width, torch)
    cold_rows = timed("phase 6", phase_profile, torch, engines)
    weights = engines["qwen3-8b"].params
    del engines["qwen3-8b-dense"]
    other = timed("phase 7", phase_eviction, torch, weights)
    timed("phase 8", phase_swap_vs_replay, torch, weights)
    other.update(timed("phase 9", phase_loadgen, torch, weights))
    timed("phase 10", phase_graphs, torch, engines, cold_rows)
    del engines, weights
    paths.update(timed("phase 11", phase_training, torch))
    families = timed("phase 12", phase_families, torch)
    families.update(timed("phase 13", phase_stub_families, torch))
    families.update(timed("phase 14", phase_finetune, torch))
    families.update(timed("phase 15", phase_roofline, torch))
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        path = MAIN_PATH[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "main_path": path,
                 "launches": paths[path][name],
                 "eviction_paths": {p: n[name] for p, n in other.items()
                                    if n[name]},
                 "family_paths": {p: n[name] for p, n in families.items()
                                  if n[name]}}
        # the top-level numbers are the first timing row's (the cloud
        # model's, qwen3-8b, for attention; zamba2's prefill for the SSD
        # scan); the other rows' follow under their own names
        labels = TIMING_ROWS.get(name, ("qwen3-8b", "qwen2-1.5b"))
        first = labels[0]
        for model in labels:
            r = timing[(name, model)]
            nums = {"shape": r["shape"], "max_abs_err": r["max_abs_err"],
                    "tolerance": TOLERANCES.get(name, BF16_TOL),
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                    "library_ms": r["library_ms"]}
            for extra in ("write_flush_ms", "library_cold_ms"):
                if extra in r:
                    nums[extra] = r[extra]
            if model == first:
                entry.update(nums)
            else:
                entry[model] = nums
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
