"""The numerics the tensor-core paged prefill kernel's design rests on, on
the CPU.

`csrc/paged_prefill_attention.cu` runs a bfloat16 query over a bf16, int8
or fp8 pool on bf16 tensor cores. Over a quantized pool it converts each
raw value to bf16 with no scale, puts the K scale on the score and folds
the V scale into P before P's bf16 rounding. The kernel itself runs only
on the card (tests/test_torch_cuda.py, chip_smoke.py phase 2); this file
checks the design's rounding points without it:

- every int8 code and every finite float8_e4m3fn code is exactly a
  bfloat16 value, so the conversion loses nothing;
- a plain PyTorch emulation of those rounding points, written here (64-key
  tiles gathered through the block table, scores from bf16 operands in f32
  times the per-key K scale, an online softmax in base 2, P times the
  per-key V scale rounded to bf16 for P.V, the running sum from the
  unscaled P), agrees within the bf16 tolerance with the JAX package's four
  paged prefill kernels in interpret mode (the ragged and single-slot
  ones, over a bf16 pool and over int8 / fp8 pools), for pages of 12 and
  32 keys that tiles span, chunks that start mid-page and a padding row.

Inputs come from a numpy seed.
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (thread count)
from repro.kernels.paged_prefill_attention import ops as jpops
from repro_torch.models import paged_cache as pc

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
KEY_TILE = 64


def test_every_int8_code_is_a_bf16_value():
    codes = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    as_bf16 = codes.to(torch.bfloat16)
    assert torch.equal(as_bf16.float(), codes.float())
    assert torch.equal(as_bf16.to(torch.int8), codes)


def test_every_finite_e4m3_code_is_a_bf16_value():
    bits = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    values = bits.view(torch.float8_e4m3fn).float()
    finite = torch.isfinite(values)
    assert int(finite.sum()) == 254          # 0x7F and 0xFF are NaN
    f = values[finite]
    # the card converts e4m3 -> half (exact) -> f32 -> bf16
    assert torch.equal(f.half().float(), f)
    as_bf16 = f.to(torch.bfloat16)
    assert torch.equal(as_bf16.float(), f)
    back = as_bf16.float().to(torch.float8_e4m3fn).view(torch.uint8)
    assert torch.equal(back, bits[finite])


def _emulate(q, k_vals, v_vals, k_scales, v_scales, block_rows, offsets,
             lens):
    """The mma kernel's arithmetic in plain PyTorch. q (R, C, Hq, hd) bf16;
    k/v_vals (n_pages, page, Hkv, hd) bf16 pool values (a quantized pool's
    codes, unscaled); k/v_scales (n_pages, Hkv) f32. Rows past lens[r] are
    zeros, as the kernel writes them."""
    R, C, Hq, hd = q.shape
    n_pages, ps, Hkv, _ = k_vals.shape
    rep = Hq // Hkv
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    out = torch.zeros(R, C, Hq, hd)
    for r in range(R):
        off, ln = int(offsets[r]), int(lens[r])
        if ln == 0:
            continue
        kpos = torch.arange(off + ln)
        pi = kpos // ps
        page = torch.where(pi < block_rows.shape[1],
                           block_rows[r, pi.clamp(max=block_rows.shape[1]
                                                  - 1)].long(),
                           torch.full_like(pi, -1))
        mapped = (page >= 0) & (page < n_pages)
        pg = page.clamp(0, n_pages - 1)
        # unmapped keys land as zeros and are masked
        k = torch.where(mapped[:, None, None], k_vals[pg, kpos % ps].float(),
                        0.0).repeat_interleave(rep, 1)     # (S, Hq, hd)
        v = torch.where(mapped[:, None, None], v_vals[pg, kpos % ps].float(),
                        0.0).repeat_interleave(rep, 1)
        sk = k_scales[pg].repeat_interleave(rep, 1).T      # (Hq, S)
        sv = v_scales[pg].repeat_interleave(rep, 1).T
        qf = q[r, :ln].float()                             # (ln, Hq, hd)
        qpos = off + torch.arange(ln)
        m = torch.full((ln, Hq), -1e30)
        l = torch.zeros(ln, Hq)
        o = torch.zeros(ln, Hq, hd)
        for k0 in range(0, off + ln, KEY_TILE):
            t = slice(k0, min(k0 + KEY_TILE, off + ln))
            s = torch.einsum("chd,khd->chk", qf, k[t]) * sk[None, :, t] \
                * scale_log2
            keep = mapped[t][None, None, :] & (
                kpos[t][None, None, :] <= qpos[:, None, None])
            s = torch.where(keep, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.where(keep, torch.exp2(s - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)                      # unscaled p
            pv = (p * sv[None, :, t]).to(torch.bfloat16).float()
            o = o * alpha[..., None] + torch.einsum("chk,khd->chd", pv, v[t])
            m = m_new
        out[r, :ln] = o / l[..., None]
    return out.to(torch.bfloat16)


def _chained_table(totals, page, P):
    tbl = np.full((len(totals), P), -1, np.int32)
    nxt = 0
    for b, n in enumerate(totals):
        live = -(-int(n) // page)
        tbl[b, :live] = np.arange(nxt, nxt + live)
        nxt += live
    return tbl


def _inputs(rng, kv, R, C, Hq, Hkv, hd, page, offsets, lens):
    """(q, k/v values for the emulation, k/v scales, block rows, and the
    JAX kernels' q and pools): a bf16 query; a bf16 pool, or a pool
    quantized per (page, kv head) as the engine's writers quantize it."""
    totals = offsets + lens
    P = -(-int(totals.max()) // page) + 1                  # -1 tail pages
    rows = _chained_table(totals, page, P)
    n_pages = int(rows.max()) + 2
    shape = (n_pages, page, Hkv, hd)
    q = torch.from_numpy(rng.standard_normal((R, C, Hq, hd)).astype(
        np.float32)).to(torch.bfloat16)
    k_f = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    v_f = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    jq = jnp.asarray(q.float().numpy()).astype(jnp.bfloat16)
    if kv == "bfloat16":
        kp, vp = k_f.to(torch.bfloat16), v_f.to(torch.bfloat16)
        ks = vs = torch.ones(n_pages, Hkv)
        jpools = [jnp.asarray(p.float().numpy()).astype(jnp.bfloat16)
                  for p in (kp, vp)]
        return q, kp, vp, ks, vs, rows, jq, jpools
    ks = pc.quant_scale(k_f.abs().amax(dim=(1, 3)), kv)
    vs = pc.quant_scale(v_f.abs().amax(dim=(1, 3)), kv)
    kp, vp = pc._quantize(k_f, ks, kv), pc._quantize(v_f, vs, kv)
    view = np.int8 if kv == "int8" else ml_dtypes.float8_e4m3fn
    jpools = [jnp.asarray(p.view(torch.uint8).numpy().view(view))
              for p in (kp, vp)] + [jnp.asarray(ks.numpy()),
                                    jnp.asarray(vs.numpy())]
    return (q, kp.float().to(torch.bfloat16), vp.float().to(torch.bfloat16),
            ks, vs, rows, jq, jpools)


def _check(got, want, lens):
    C = got.shape[1]
    live = torch.arange(C)[None, :] < torch.as_tensor(lens)[:, None]
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert torch.isfinite(got.float()).all()
    assert torch.all(got[~live] == 0)
    torch.testing.assert_close(got[live].float(), want[live], **BF16_TOL)


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("page", [12, 32])
@pytest.mark.parametrize("Hq,Hkv", [(8, 2), (12, 2)])
def test_mma_rounding_points_match_the_plain_version(kv, page, Hq, Hkv):
    """The ragged kernels, #2 and #6."""
    rng = np.random.default_rng([len(kv), page, Hq])
    hd, C = 32, 37
    # a mid-prompt chunk starting mid-page (3 key tiles), a first chunk, a
    # chunk ending mid-tile, a padding row
    offsets = np.array([100, 0, 64 + 5, 0], np.int32)
    lens = np.array([C, 20, C, 0], np.int32)
    q, kv_k, kv_v, ks, vs, rows, jq, jpools = _inputs(
        rng, kv, 4, C, Hq, Hkv, hd, page, offsets, lens)
    got = _emulate(q, kv_k, kv_v, ks, vs, *(torch.from_numpy(a) for a in
                                            (rows, offsets, lens)))
    fn = (jpops.paged_prefill_attention_ragged if kv == "bfloat16"
          else jpops.paged_prefill_attention_ragged_quant)
    want = fn(jq, *jpools, jnp.asarray(rows), jnp.asarray(offsets),
              jnp.asarray(lens), interpret=True)
    _check(got, want, lens)


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("page", [12, 32])
def test_mma_rounding_points_match_the_single_slot_kernels(kv, page):
    """The single-slot kernels, #3 and #5: a chunk of 37 starting mid-page
    after 75 cached tokens."""
    rng = np.random.default_rng([len(kv), page, 1])
    Hq, Hkv, hd, C = 12, 2, 32, 37
    offsets, lens = np.array([75], np.int32), np.array([C], np.int32)
    q, kv_k, kv_v, ks, vs, rows, jq, jpools = _inputs(
        rng, kv, 1, C, Hq, Hkv, hd, page, offsets, lens)
    got = _emulate(q, kv_k, kv_v, ks, vs, *(torch.from_numpy(a) for a in
                                            (rows, offsets, lens)))
    fn = (jpops.paged_prefill_attention if kv == "bfloat16"
          else jpops.paged_prefill_attention_quant)
    want = fn(jq, *jpools, jnp.asarray(rows[0]), jnp.int32(offsets[0]),
              jnp.int32(lens[0]), interpret=True)
    _check(got, want, lens)
