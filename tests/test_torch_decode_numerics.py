"""The numerics the tensor-core decode kernel's design rests on, on the CPU.

`csrc/flash_decode.cuh`'s `decode_kernel_mma` runs a bfloat16 query over a
bf16, int8 or fp8 pool (paged) or a bf16 cache (dense) on bf16 tensor
cores, and merges the splits of a (slot, kv head) inside a thread-block
cluster. The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 2); this file checks its rounding points and merges
without it. A plain PyTorch emulation, written here:

- each split of the planner (`split_pages` / `split_rows`) walks its keys
  in 64-key tiles, four warps taking 16 keys of each tile;
- scores from bf16 operands in f32, times the per-key K scale, in base 2;
  keys past the length, past the split or on an unmapped page carry no
  weight;
- an online softmax per warp; P times the per-key V scale rounded to bf16
  for P.V; the running sum from the unscaled P;
- the four warps' (m, l, acc) combined into the block's, then the splits'
  combined as the cluster's rank 0 combines them (a slot with no keys
  gives zeros);

agrees within the bf16 tolerance with the JAX package's
`paged_decode_attention_pallas`, `paged_decode_attention_quant_pallas`
(int8 and fp8) and `decode_attention_pallas` in interpret mode, for pages
of 12 and 32 keys, q_per_kv 4 and 6, the planner's split counts on a full
card (several splits) and on one SM (one split of several tiles), and a
zero-length slot. Inputs come from a numpy seed; int8 / fp8 codes are
exact in bf16 (tests/test_torch_prefill_numerics.py).
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (thread count)
from repro.kernels.decode_attention import ops as jdops
from repro.kernels.paged_decode_attention import ops as jpdops
from repro_torch.kernels.decode_attention.kernel import split_rows
from repro_torch.kernels.decode_attention import ref as dref
from repro_torch.kernels.paged_decode_attention import ref as pdref
from repro_torch.kernels.paged_decode_attention.kernel import (MAX_SPLITS,
                                                               split_pages)
from repro_torch.models import paged_cache as pc

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
KEY_TILE = 64
WARPS = 4
WARP_KEYS = KEY_TILE // WARPS
NEG = -1e30


def _scale_log2(hd):
    """log2(e) / sqrt(hd) as the kernel computes it, in float32."""
    return float(np.float32(1.4426950408889634) / np.sqrt(np.float32(hd)))


def _block(qf, k, v, sk, sv, ok, t0, t1, scale_log2):
    """One block's (m, l, acc) over keys [t0, t1) of one (slot, kv head):
    qf (rep, hd) f32; k/v (S, hd) bf16 values as f32 (zero where a key has
    no row); sk/sv (S,) scales; ok (S,) keys with a row."""
    rep, hd = qf.shape
    S = k.shape[0]
    states = []
    for w in range(WARPS):
        m = torch.full((rep,), NEG)
        l = torch.zeros(rep)
        o = torch.zeros(rep, hd)
        for k0 in range(t0, t1, KEY_TILE):
            keys = torch.arange(k0 + w * WARP_KEYS, k0 + (w + 1) * WARP_KEYS)
            at = keys.clamp(max=S - 1)
            live = (keys < t1) & ok[at]
            kk = torch.where(live[:, None], k[at], 0.0)
            vv = torch.where(live[:, None], v[at], 0.0)
            s = (qf @ kk.T) * sk[at] * scale_log2
            s = torch.where(live[None], s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.where(live[None], torch.exp2(s - m_new[:, None]), 0.0)
            l = l * alpha + p.sum(-1)                  # unscaled p
            pv = (p * sv[at]).to(torch.bfloat16).float()
            o = o * alpha[:, None] + pv @ vv
            m = m_new
        states.append((m, l, o))
    mw = torch.stack([st[0] for st in states])         # (4, rep)
    top = mw.amax(0)
    a = torch.exp2(mw - top)
    return (top, (a * torch.stack([st[1] for st in states])).sum(0),
            (a[..., None] * torch.stack([st[2] for st in states])).sum(0))


def _cluster_merge(parts):
    """Rank 0's combination of the splits' (m, l, acc)."""
    m = torch.stack([p[0] for p in parts])             # (splits, rep)
    w = torch.exp2(m - m.amax(0))
    den = (w * torch.stack([p[1] for p in parts])).sum(0)
    num = (w[..., None] * torch.stack([p[2] for p in parts])).sum(0)
    return torch.where(den[:, None] == 0, 0.0,
                       num / torch.where(den == 0, 1.0, den)[:, None])


def _emulate(q, keys_k, keys_v, sk, sv, ok, lengths, spans):
    """q (B, 1, Hq, hd) bf16; keys_k/v (B, S, Hkv, hd) each slot's keys in
    order as bf16 values (a quantized pool's codes, unscaled); sk/sv (B, S,
    Hkv); ok (B, S) keys with a row; spans: each split's key range
    [t0, t_end) before the length cuts it."""
    B, _, Hq, hd = q.shape
    Hkv = keys_k.shape[2]
    rep = Hq // Hkv
    sl2 = _scale_log2(hd)
    out = torch.zeros(B, 1, Hq, hd)
    for b in range(B):
        ln = int(lengths[b])
        for h in range(Hkv):
            qf = q[b, 0, h * rep:(h + 1) * rep].float()
            parts = [_block(qf, keys_k[b, :, h].float(),
                            keys_v[b, :, h].float(), sk[b, :, h],
                            sv[b, :, h], ok[b], t0, min(t_end, ln), sl2)
                     for t0, t_end in spans]
            out[b, 0, h * rep:(h + 1) * rep] = _cluster_merge(parts)
    return out.to(torch.bfloat16)


def _paged_inputs(rng, kv, B, Hq, Hkv, hd, page, lens):
    """bf16 q; a pool (bf16, or quantized per (page, kv head) as the
    engine's writers quantize it) over disjoint page chains with -1 tails,
    NaN (bf16, fp8) or 127 (int8) stored past each length."""
    P = -(-int(max(lens)) // page) + 1
    table = np.full((B, P), -1, np.int32)
    nxt = 0
    for b, n in enumerate(lens):
        live = -(-int(n) // page)
        table[b, :live] = np.arange(nxt, nxt + live)
        nxt += live
    n_pages = nxt + 2
    shape = (n_pages, page, Hkv, hd)
    q = torch.from_numpy(rng.standard_normal((B, 1, Hq, hd)).astype(
        np.float32)).to(torch.bfloat16)
    k_f = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v_f = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if kv == "bfloat16":
        kp, vp = k_f.to(torch.bfloat16), v_f.to(torch.bfloat16)
        ks = vs = torch.ones(n_pages, Hkv)
    else:
        ks = pc.quant_scale(k_f.abs().amax(dim=(1, 3)), kv)
        vs = pc.quant_scale(v_f.abs().amax(dim=(1, 3)), kv)
        kp, vp = pc._quantize(k_f, ks, kv), pc._quantize(v_f, vs, kv)
    for p in (kp, vp):
        raw = p.view(torch.uint8)
        for b, n in enumerate(lens):
            if n % page:
                pg = int(table[b, n // page])
                if kv == "bfloat16":
                    p[pg, n % page:] = float("nan")
                else:
                    raw[pg, n % page:] = 0x7F
    return q, kp, vp, ks, vs, torch.from_numpy(table)


def _paged_emulation(q, kp, vp, ks, vs, table, lens, n_sm):
    """The kernel's arithmetic over the paged pool, split as the planner
    splits it for a card of n_sm SMs."""
    B, P = table.shape
    n_pages, page, Hkv, _ = kp.shape
    splits, per = split_pages(B, Hkv, P, n_sm)
    assert 1 <= splits <= MAX_SPLITS
    t = torch.arange(P * page)
    pg = table[:, t // page].long()                    # (B, S)
    ok = (pg >= 0) & (pg < n_pages)
    pgc = pg.clamp(0, n_pages - 1)
    vals = [torch.where(ok[..., None, None],
                        p.float()[pgc, t % page], 0.0).to(torch.bfloat16)
            for p in (kp, vp)]
    sk, sv = (torch.where(ok[..., None], s[pgc], 0.0) for s in (ks, vs))
    spans = [(s * per * page, min((s + 1) * per, P) * page)
             for s in range(splits)]
    return _emulate(q, *vals, sk, sv, ok, lens, spans), splits


def _jax_paged(kv, q, kp, vp, ks, vs, table, lens):
    jq = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
    jt, jl = jnp.asarray(table.numpy()), jnp.asarray(lens)
    if kv == "bfloat16":
        pools = [jnp.asarray(p.float().numpy()).astype(jnp.bfloat16)
                 for p in (kp, vp)]
        return jpdops.paged_decode_attention(jq, *pools, jt, jl,
                                             interpret=True)
    view = np.int8 if kv == "int8" else ml_dtypes.float8_e4m3fn
    pools = [jnp.asarray(p.view(torch.uint8).numpy().view(view))
             for p in (kp, vp)]
    return jpdops.paged_decode_attention_quant(
        jq, *pools, jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()), jt, jl,
        interpret=True)


def _as_torch(x):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))


@pytest.mark.parametrize("n_sm", [132, 1])
@pytest.mark.parametrize("kv", ["bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("page", [12, 32])
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (12, 2)])
def test_paged_rounding_points_match_the_pallas_kernels(n_sm, kv, page, Hq,
                                                        Hkv):
    """#1 (bf16 pool) and #4 (int8, fp8): a zero-length slot, a slot of
    several tiles, a short one; on a full card the planner gives several
    splits, on one SM one split walking every tile."""
    rng = np.random.default_rng([len(kv), page, Hq, n_sm])
    hd = 32
    lens = np.array([0, 150, 19], np.int32)
    q, kp, vp, ks, vs, table = _paged_inputs(rng, kv, 3, Hq, Hkv, hd, page,
                                             lens)
    got, splits = _paged_emulation(q, kp, vp, ks, vs, table, lens, n_sm)
    assert (splits > 1) == (n_sm > 1)
    want = _as_torch(_jax_paged(kv, q, kp, vp, ks, vs, table, lens))
    assert torch.isfinite(got.float()).all()
    assert torch.all(got[0] == 0), "a zero-length slot gives zeros"
    torch.testing.assert_close(got.float(), want, **BF16_TOL)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_paged_emulation_matches_the_plain_version(kv):
    """The same emulation against the port's plain version (gather, then
    attention) at qwen3-8b's head_dim, with COW-shared prefix pages."""
    rng = np.random.default_rng([7, len(kv)])
    lens = np.array([200, 77, 0, 64], np.int32)
    q, kp, vp, ks, vs, table = _paged_inputs(rng, kv, 4, 8, 2, 128, 32,
                                             lens)
    table[1, :2] = table[0, :2]                        # shared prefix pages
    got, _ = _paged_emulation(q, kp, vp, ks, vs, table, lens, 132)
    lt = torch.from_numpy(lens)
    if kv == "bfloat16":
        want = pdref.paged_decode_attention_ref(q, kp, vp, table, lt)
    else:
        want = pdref.paged_decode_attention_quant_ref(q, kp, vp, ks, vs,
                                                      table, lt)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("n_sm", [132, 1])
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (12, 2)])
def test_dense_rounding_points_match_the_pallas_kernel(n_sm, Hq, Hkv):
    """#8 over a bf16 cache of S = 200 rows (no multiple of a tile), NaN
    past each length, a zero-length slot; splits of the dense planner."""
    rng = np.random.default_rng([Hq, n_sm])
    B, S, hd = 3, 200, 32
    lens = np.array([0, 200, 77], np.int32)
    q = torch.from_numpy(rng.standard_normal((B, 1, Hq, hd)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    ok = torch.arange(S)[None, :] < torch.from_numpy(lens)[:, None]
    k = torch.where(ok[..., None, None], k, float("nan"))
    v = torch.where(ok[..., None, None], v, float("nan"))
    splits, per = split_rows(B, Hkv, S, n_sm)
    assert (splits > 1) == (n_sm > 1) and splits <= MAX_SPLITS
    spans = [(s * per, min((s + 1) * per, S)) for s in range(splits)]
    ones = torch.ones(B, S, Hkv)
    keys = [torch.where(ok[..., None, None], x, 0.0) for x in (k, v)]
    got = _emulate(q, *keys, ones, ones, torch.ones(B, S, dtype=torch.bool),
                   lens, spans)
    want = _as_torch(jdops.decode_attention(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          for x in (q, k, v)), jnp.asarray(lens), block_s=64,
        interpret=True))
    assert torch.all(got[0] == 0)
    torch.testing.assert_close(got.float(), want, **BF16_TOL)
    torch.testing.assert_close(
        got.float(),
        dref.decode_attention_ref(q, k, v, torch.from_numpy(lens)).float(),
        **BF16_TOL)
