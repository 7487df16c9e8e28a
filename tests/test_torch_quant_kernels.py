"""The port's three `_quant` paged-attention wrappers on CPU tensors (their
plain versions: dequantize-gather, then attention in f32) against the JAX
package's `_quant_pallas` kernels in interpret mode on the same quantized
pool (rtol = atol = 2e-5), and against the float kernels on the pool before
quantization (tests/test_kv_quant_swap.py's loose 0.15 / 0.1 for int8, twice
that for fp8: see `LOOSE`). Case
families: ragged lengths including 0, unmapped -1 tail pages, COW-shared
pages, padding ingest rows, a chunk that starts mid-page, NaN stored past a
slot's length (fp8), head_dim 16/24/32, q_per_kv 1-6, page 8/16. The float
wrappers take a pool dtype other than q's. A CPU tensor counts no kernel
launch."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (thread count)
from repro.kernels.paged_decode_attention import ops as jdops
from repro.kernels.paged_prefill_attention import ops as jpops
from repro_torch.kernels.paged_decode_attention import ops as dops
from repro_torch.kernels.paged_prefill_attention import ops as pops
from repro_torch.models import paged_cache as tpc

TOL = dict(rtol=2e-5, atol=2e-5)       # kernel vs dequant oracle, f32
# quantized vs float pool: quantization error, not a fault. An e4m3 value
# keeps 3 mantissa bits, so it rounds by up to 1/16 of itself, where int8
# rounds by up to 1/254 of its page's abs-max; over 80 random decode cases
# of these shapes int8 used at most 0.31 of the 0.15 / 0.1 bound and fp8
# up to 1.35 of it, so fp8 is held to twice the bound.
LOOSE = {"int8": dict(rtol=0.15, atol=0.1), "fp8": dict(rtol=0.3, atol=0.2)}
FP8_NAN = 0x7F                         # an e4m3fn NaN byte


def _chained_table(lens, page, P):
    tbl = np.full((len(lens), P), -1, np.int32)
    nxt = 0
    for b, ln in enumerate(lens):
        live = -(-int(ln) // page)
        tbl[b, :live] = np.arange(nxt, nxt + live)
        nxt += live
    return tbl


def _quantized(rng, n_pages, page, Hkv, hd, kv_dtype):
    """A float pool and its quantization (scale from each (page, head)'s
    abs-max), as numpy: (float, storage bytes as uint8, scales)."""
    f = (rng.standard_normal((n_pages, page, Hkv, hd)) * 1.5).astype(
        np.float32)
    scale = tpc.quant_scale(torch.from_numpy(np.abs(f).max(axis=(1, 3))),
                            kv_dtype)
    q = tpc._quantize(torch.from_numpy(f), scale, kv_dtype)
    return f, q.view(torch.uint8).numpy().copy(), scale.numpy()


def _poison(raw, table, lens, page, kv_dtype):
    """Store NaN (fp8) or the extreme value (int8) at every position of
    each row's last mapped page past its length."""
    bad = FP8_NAN if kv_dtype == "fp8" else 0x7F
    for b, ln in enumerate(lens):
        if ln % page:
            raw[table[b, ln // page], ln % page:] = bad


def _pools(rng, n_pages, page, Hkv, hd, kv_dtype, table, lens):
    kf, kraw, ks = _quantized(rng, n_pages, page, Hkv, hd, kv_dtype)
    vf, vraw, vs = _quantized(rng, n_pages, page, Hkv, hd, kv_dtype)
    _poison(kraw, table, lens, page, kv_dtype)
    _poison(vraw, table, lens, page, kv_dtype)
    return kf, vf, kraw, vraw, ks, vs


def _t_pool(raw, kv_dtype):
    return torch.from_numpy(raw).view(tpc.kv_storage_dtype(kv_dtype))


def _j_pool(raw, kv_dtype):
    if kv_dtype == "int8":
        return jnp.asarray(raw.view(np.int8))
    return jnp.asarray(raw.view(ml_dtypes.float8_e4m3fn))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# (B, Hq, Hkv, hd, page, P): q_per_kv 4, 1, 3, 6; head_dim 16, 24, 32
DECODE_CASES = [(3, 8, 2, 32, 8, 6), (2, 4, 4, 24, 16, 4),
                (3, 6, 2, 16, 8, 5), (2, 12, 2, 32, 16, 3)]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("B,Hq,Hkv,hd,page,P", DECODE_CASES)
def test_paged_decode_quant_plain_vs_pallas(kv_dtype, B, Hq, Hkv, hd, page,
                                            P):
    rng = np.random.default_rng(hd + page)
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    lens = rng.integers(1, P * page + 1, B).astype(np.int32)
    lens[0] = 0                                 # a length-0 slot
    lens[-1] = page + page // 2                 # a mid-page partial length
    table = _chained_table(lens, page, P)       # -1 tail pages
    kf, vf, kraw, vraw, ks, vs = _pools(rng, B * P + 2, page, Hkv, hd,
                                        kv_dtype, table, lens)
    before = dops.paged_decode_attention_quant.launches
    got = dops.paged_decode_attention_quant(
        torch.from_numpy(q), _t_pool(kraw, kv_dtype), _t_pool(vraw, kv_dtype),
        *_t(ks, vs, table, lens))
    assert dops.paged_decode_attention_quant.launches == before
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    pallas = jdops.paged_decode_attention_quant(
        jnp.asarray(q), _j_pool(kraw, kv_dtype), _j_pool(vraw, kv_dtype),
        *_j(ks, vs, table, lens), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_array_equal(got[0].numpy(), 0.0)
    floats = dops.paged_decode_attention(*_t(q, kf, vf, table, lens))
    np.testing.assert_allclose(got.numpy(), floats.numpy(),
                               **LOOSE[kv_dtype])


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_paged_decode_quant_cow_shared_pages(kv_dtype):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 1, 8, 32)).astype(np.float32)
    table = np.array([[0, 1, 2, -1], [0, 1, 3, 4]], np.int32)
    lens = np.array([20, 28], np.int32)
    _, _, kraw, vraw, ks, vs = _pools(rng, 12, 8, 2, 32, kv_dtype, table,
                                      lens)
    got = dops.paged_decode_attention_quant(
        torch.from_numpy(q), _t_pool(kraw, kv_dtype), _t_pool(vraw, kv_dtype),
        *_t(ks, vs, table, lens))
    pallas = jdops.paged_decode_attention_quant(
        jnp.asarray(q), _j_pool(kraw, kv_dtype), _j_pool(vraw, kv_dtype),
        *_j(ks, vs, table, lens), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


# (Hq, Hkv, hd, page, C): q_per_kv 4, 1, 3, 2
PREFILL_CASES = [(8, 2, 32, 8, 16), (4, 4, 24, 16, 24), (6, 2, 16, 8, 12),
                 (4, 2, 32, 16, 32)]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("Hq,Hkv,hd,page,C", PREFILL_CASES)
def test_paged_prefill_ragged_quant_plain_vs_pallas(kv_dtype, Hq, Hkv, hd,
                                                    page, C):
    rng = np.random.default_rng(C + hd)
    P = -(-(2 * C + page) // page)
    # rows: a mid-prompt chunk, a first chunk, a tail chunk starting
    # mid-page, padding
    offs = np.array([C, 0, page + 3, 0], np.int32)
    lens = np.array([C, C // 2, 5, 0], np.int32)
    R = len(offs)
    table = _chained_table(offs + lens, page, P)
    table[1, :2] = table[0, :2]                 # COW-shared prefix pages
    kf, vf, kraw, vraw, ks, vs = _pools(rng, int(table.max()) + 3, page, Hkv,
                                        hd, kv_dtype, table[[0, 2]],
                                        (offs + lens)[[0, 2]])
    q = rng.standard_normal((R, C, Hq, hd)).astype(np.float32)
    before = pops.paged_prefill_attention_ragged_quant.launches
    got = pops.paged_prefill_attention_ragged_quant(
        torch.from_numpy(q), _t_pool(kraw, kv_dtype), _t_pool(vraw, kv_dtype),
        *_t(ks, vs, table, offs, lens))
    assert pops.paged_prefill_attention_ragged_quant.launches == before
    pallas = np.asarray(jpops.paged_prefill_attention_ragged_quant(
        jnp.asarray(q), _j_pool(kraw, kv_dtype), _j_pool(vraw, kv_dtype),
        *_j(ks, vs, table, offs, lens), interpret=True))
    floats = pops.paged_prefill_attention_ragged(
        *_t(q, kf, vf, table, offs, lens))
    for r in range(R):                          # rows past lens unspecified
        n = lens[r]
        assert torch.isfinite(got[r, :n]).all()
        np.testing.assert_allclose(got[r, :n].numpy(), pallas[r, :n], **TOL)
        np.testing.assert_allclose(got[r, :n].numpy(),
                                   floats[r, :n].numpy(),
                                   **LOOSE[kv_dtype])


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("offset,chunk_len", [(0, 16), (21, 9), (40, 1)])
def test_paged_prefill_quant_plain_vs_pallas(kv_dtype, offset, chunk_len):
    rng = np.random.default_rng(offset)
    C, Hq, Hkv, hd, page = 16, 8, 2, 32, 8
    row = np.array([3, 7, 1, 9, 0, 5, 2, -1], np.int32)
    kf, vf, kraw, vraw, ks, vs = _pools(rng, 12, page, Hkv, hd, kv_dtype,
                                        row[None], [offset + chunk_len])
    q = rng.standard_normal((1, C, Hq, hd)).astype(np.float32)
    before = pops.paged_prefill_attention_quant.launches
    got = pops.paged_prefill_attention_quant(
        torch.from_numpy(q), _t_pool(kraw, kv_dtype), _t_pool(vraw, kv_dtype),
        *_t(ks, vs, row), offset, chunk_len)
    assert pops.paged_prefill_attention_quant.launches == before
    pallas = jpops.paged_prefill_attention_quant(
        jnp.asarray(q), _j_pool(kraw, kv_dtype), _j_pool(vraw, kv_dtype),
        *_j(ks, vs, row), jnp.int32(offset), jnp.int32(chunk_len),
        interpret=True)
    np.testing.assert_allclose(got[0, :chunk_len].numpy(),
                               np.asarray(pallas)[0, :chunk_len], **TOL)
    floats = pops.paged_prefill_attention(*_t(q, kf, vf, row), offset,
                                          chunk_len)
    np.testing.assert_allclose(got[0, :chunk_len].numpy(),
                               floats[0, :chunk_len].numpy(),
                               **LOOSE[kv_dtype])


def test_ragged_quant_rows_equal_single_slot():
    """Each ragged row is the single-slot wrapper on the same pool."""
    rng = np.random.default_rng(11)
    page, Hkv, hd, C = 8, 2, 16, 8
    offs, lens = np.array([11, 0], np.int32), np.array([8, 8], np.int32)
    table = _chained_table(offs + lens, page, 3)
    _, _, kraw, vraw, ks, vs = _pools(rng, 8, page, Hkv, hd, "int8", table,
                                      offs + lens)
    q = torch.from_numpy(rng.standard_normal((2, C, 4, hd)).astype(
        np.float32))
    kp, vp = _t_pool(kraw, "int8"), _t_pool(vraw, "int8")
    ks_t, vs_t, tbl = _t(ks, vs, table)
    out = pops.paged_prefill_attention_ragged_quant(
        q, kp, vp, ks_t, vs_t, tbl, *_t(offs, lens))
    for r in range(2):
        single = pops.paged_prefill_attention_quant(
            q[r:r + 1], kp, vp, ks_t, vs_t, tbl[r], int(offs[r]),
            int(lens[r]))
        torch.testing.assert_close(out[r:r + 1], single, rtol=0, atol=0)


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_float_wrappers_take_another_pool_dtype(q_dtype, kv_dtype):
    """A float pool of another type than q's (kv_dtype narrower or wider
    than the compute dtype): the output is in q's type and equals the
    plain version on the pool cast to q's type, within the pool's rounding;
    the Pallas kernels cast to f32 inside, as the port's do."""
    rng = np.random.default_rng(3)
    B, Hq, Hkv, hd, page, P = 2, 8, 2, 32, 8, 4
    lens = np.array([13, 30], np.int32)
    table = _chained_table(lens, page, P)
    kp = torch.from_numpy(rng.standard_normal((B * P + 1, page, Hkv, hd))
                          .astype(np.float32)).to(kv_dtype)
    vp = torch.from_numpy(rng.standard_normal((B * P + 1, page, Hkv, hd))
                          .astype(np.float32)).to(kv_dtype)
    q = torch.from_numpy(rng.standard_normal((B, 1, Hq, hd)).astype(
        np.float32)).to(q_dtype)
    got = dops.paged_decode_attention(q, kp, vp, *_t(table, lens))
    assert got.dtype == q_dtype
    pallas = jdops.paged_decode_attention(
        jnp.asarray(q.float().numpy()).astype(
            jnp.bfloat16 if q_dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(kp.float().numpy()).astype(
            jnp.bfloat16 if kv_dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(vp.float().numpy()).astype(
            jnp.bfloat16 if kv_dtype == torch.bfloat16 else jnp.float32),
        *_j(table, lens), interpret=True)
    tol = TOL if q_dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas).astype(np.float32), **tol)
    offs, ln = np.array([5, 0], np.int32), np.array([8, 8], np.int32)
    qc = q.expand(B, 8, Hq, hd).contiguous()
    got = pops.paged_prefill_attention_ragged(qc, kp, vp, *_t(table, offs,
                                                              ln))
    assert got.dtype == q_dtype
    want = pops.paged_prefill_attention_ragged(qc, kp.to(q_dtype),
                                               vp.to(q_dtype),
                                               *_t(table, offs, ln))
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_wrappers_refuse_mismatched_pools():
    """On the card the wrappers check what the kernel takes; the checks run
    before any launch, so they are tested here."""
    from repro_torch.kernels import runtime
    q8 = torch.zeros(2, 8, 2, 32, dtype=torch.int8)
    scales = torch.ones(2, 2)
    with pytest.raises(ValueError):             # float wrapper, int8 pool
        runtime.check_pools(q8, q8, None, None)
    with pytest.raises(ValueError):             # quant wrapper, float pool
        runtime.check_pools(q8.float(), q8.float(), scales, scales)
    with pytest.raises(ValueError):             # one scale tensor missing
        runtime.check_pools(q8, q8, scales, None)
    with pytest.raises(ValueError):             # scales of the wrong shape
        runtime.check_pools(q8, q8, torch.ones(3, 2), torch.ones(3, 2))
    runtime.check_pools(q8, q8, scales, scales)
    runtime.check_limits(16, 24, torch.bfloat16)
    with pytest.raises(ValueError):             # 24 values: three 8-byte
        runtime.check_limits(16, 20, torch.int8)  # pieces, 20 is not
    runtime.check_limits(16, 24, torch.float8_e4m3fn)
