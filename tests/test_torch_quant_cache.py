"""The quantized half of the port's models/paged_cache.py against the JAX
package's on the same float K/V and the same starting pool: the three
requantizing writers store the same bytes and scales (unmapped -1 pages,
inactive rows, padding rows, a chunk that starts mid-page, values at the
fp8 +-448 edge), `gather_sequence_dequant` gives the same values, the fp8
cast agrees with ml_dtypes inside +-448, and token-by-token writes stay
within the requantization bound of a bulk write."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import _torch_common  # noqa: F401  (thread count)
from repro.models import paged_cache as jpc
from repro_torch.models import paged_cache as tpc

N_PAGES, KV = 9, 2
# block table: row 0 maps pages 3,4; row 1 maps 5 then -1; row 2 shares
# page 3 with row 0 (a COW sibling) and maps 6; row 3 is unmapped
TABLE = np.array([[3, 4, -1], [5, -1, -1], [3, 6, -1], [-1, -1, -1]],
                 np.int32)
CASES = [(kv, hd, page) for kv in ("int8", "fp8")
         for hd, page in ((16, 8), (24, 16), (32, 8))]


def _start(kv_dtype, page, hd, seed):
    """A quantized pool and scales (the port's scratch page included as a
    plain page on the JAX side), as numpy storage bytes and f32 scales."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((N_PAGES, page, KV, hd)) * 3).astype(np.float32)
    sc = (rng.random((N_PAGES, KV)) * 0.05 + 0.01).astype(np.float32)
    y = x / sc[:, None, :, None]
    if kv_dtype == "int8":
        q = np.clip(np.round(y), -127, 127).astype(np.int8)
    else:
        q = np.clip(y, -448, 448).astype(ml_dtypes.float8_e4m3fn)
    return q, sc


def _torch_pool(q, sc, kv_dtype):
    pages = torch.from_numpy(q.view(np.uint8).copy()).view(
        tpc.kv_storage_dtype(kv_dtype))
    return pages, torch.from_numpy(sc.copy())


def _same(tp, ts, jp, js):
    """Equal storage bytes and scales, apart from the port's scratch page
    (the last page, where dropped writes land)."""
    np.testing.assert_array_equal(tp.view(torch.uint8).numpy()[:-1],
                                  np.asarray(jp).view(np.uint8)[:-1])
    np.testing.assert_array_equal(ts.numpy()[:-1], np.asarray(js)[:-1])


def _new(rng, shape, edge=False):
    """Float K/V; with `edge`, each (row, head) holds a +-|max| pair so the
    fp8 quantization lands on +-448."""
    x = (rng.standard_normal(shape) * 4).astype(np.float32)
    if edge:
        x[..., 0] = 9.5
        x[..., 1] = -9.5
    return x


@pytest.mark.parametrize("kv_dtype,hd,page", CASES)
@pytest.mark.parametrize("active", [None, [True, False, True, True]])
def test_write_token_quant_same_bytes(kv_dtype, hd, page, active):
    """Drops: an inactive row (row 1), row 3's unmapped page; rows 0 and 2
    write mid-page, row 2 on its second page."""
    q, sc = _start(kv_dtype, page, hd, 0)
    tk, tks = _torch_pool(q, sc, kv_dtype)
    tv, tvs = tk.clone(), tks.clone()
    rng = np.random.default_rng(1)
    nk = _new(rng, (4, 1, KV, hd), edge=True)
    nv = _new(rng, (4, 1, KV, hd))
    lens = np.array([page // 2, 3, page + 1, 2], np.int32)
    act_t = None if active is None else torch.tensor(active)
    act_j = None if active is None else jnp.asarray(active)
    tpc.write_token_quant(tk, tv, tks, tvs, torch.from_numpy(TABLE),
                          torch.from_numpy(lens), torch.from_numpy(nk),
                          torch.from_numpy(nv), kv_dtype, active=act_t)
    jk, jv, jks, jvs = jpc.write_token_quant(
        jnp.asarray(q), jnp.asarray(q), jnp.asarray(sc), jnp.asarray(sc),
        jnp.asarray(TABLE), jnp.asarray(lens), jnp.asarray(nk),
        jnp.asarray(nv), kv_dtype, active=act_j)
    _same(tk, tks, jk, jks)
    _same(tv, tvs, jv, jvs)
    # nothing outside the kept writes changed: page 0 and row 1's page 5
    np.testing.assert_array_equal(tk.view(torch.uint8)[0].numpy(),
                                  q.view(np.uint8)[0])
    if active is not None:
        np.testing.assert_array_equal(tks[5].numpy(), sc[5])


@pytest.mark.parametrize("kv_dtype,hd,page", CASES)
def test_write_prompt_ragged_quant_same_bytes(kv_dtype, hd, page):
    """Row 0 starts mid-page and crosses into its second page; row 1 runs
    into its unmapped second page; row 2 starts mid-page on its second
    page; row 3 is a padding row."""
    q, sc = _start(kv_dtype, page, hd, 2)
    tk, tks = _torch_pool(q, sc, kv_dtype)
    tv, tvs = tk.clone(), tks.clone()
    rng = np.random.default_rng(3)
    R, C = 4, 6
    nk = _new(rng, (R, C, KV, hd), edge=True)
    nv = _new(rng, (R, C, KV, hd))
    offs = np.array([page - 3, page - 4, page + 2, 0], np.int32)
    lens = np.array([6, 6, 3, 0], np.int32)
    tpc.write_prompt_ragged_quant(tk, tv, tks, tvs, torch.from_numpy(TABLE),
                                  torch.from_numpy(nk), torch.from_numpy(nv),
                                  torch.from_numpy(lens),
                                  torch.from_numpy(offs), kv_dtype)
    jk, jv, jks, jvs = jpc.write_prompt_ragged_quant(
        jnp.asarray(q), jnp.asarray(q), jnp.asarray(sc), jnp.asarray(sc),
        jnp.asarray(TABLE), jnp.asarray(nk), jnp.asarray(nv),
        jnp.asarray(lens), jnp.asarray(offs), kv_dtype)
    _same(tk, tks, jk, jks)
    _same(tv, tvs, jv, jvs)


@pytest.mark.parametrize("kv_dtype,hd,page", CASES)
@pytest.mark.parametrize("offset,plen", [(0, 11), (3, 5), (14, 2)])
def test_write_prompt_quant_same_bytes(kv_dtype, hd, page, offset, plen):
    q, sc = _start(kv_dtype, page, hd, 4)
    tk, tks = _torch_pool(q, sc, kv_dtype)
    tv, tvs = tk.clone(), tks.clone()
    rng = np.random.default_rng(5)
    nk = _new(rng, (1, 16, KV, hd), edge=True)
    nv = _new(rng, (1, 16, KV, hd))
    row = TABLE[0]
    tpc.write_prompt_quant(tk, tv, tks, tvs, torch.from_numpy(row),
                           torch.from_numpy(nk), torch.from_numpy(nv), plen,
                           kv_dtype, offset=offset)
    jk, jv, jks, jvs = jpc.write_prompt_quant(
        jnp.asarray(q), jnp.asarray(q), jnp.asarray(sc), jnp.asarray(sc),
        jnp.asarray(row), jnp.asarray(nk), jnp.asarray(nv),
        jnp.asarray(plen), kv_dtype, offset=offset)
    _same(tk, tks, jk, jks)
    _same(tv, tvs, jv, jvs)


@pytest.mark.parametrize("kv_dtype,hd,page", CASES)
def test_gather_sequence_dequant_same_values(kv_dtype, hd, page):
    q, sc = _start(kv_dtype, page, hd, 6)
    tk, tks = _torch_pool(q, sc, kv_dtype)
    got = tpc.gather_sequence_dequant(tk, tks, torch.from_numpy(TABLE))
    want = jpc.gather_sequence_dequant(jnp.asarray(q), jnp.asarray(sc),
                                       jnp.asarray(TABLE))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fp8_cast_agrees_with_ml_dtypes_inside_448():
    """PyTorch saturates past +-464 where ml_dtypes gives NaN; inside the
    +-448 that `_quantize` produces (its scale is amax / 448) the two round
    alike, to nearest even."""
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(-448, 448, 4096),
                        [448.0, -448.0, 447.99, 440.0, 432.0, 0.0, -0.0,
                         1e-9, 2.0 ** -10, 3.0 * 2.0 ** -10]]
                       ).astype(np.float32)
    got = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.uint8)
    want = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    np.testing.assert_array_equal(got.numpy(), want)
    amax = torch.tensor([[3.5, 0.0]])
    scale = tpc.quant_scale(amax, "fp8")
    assert scale[0, 1] == 1.0                  # an empty head keeps scale 1
    y = torch.tensor([3.5, -3.5]).reshape(1, 1, 1, 2).expand(1, 1, 2, 2)
    stored = tpc._quantize(y, scale, "fp8").float()
    assert stored[0, 0, 0].tolist() == [448.0, -448.0]


@settings(max_examples=6, deadline=None)
@given(kv_dtype=st.sampled_from(["int8", "fp8"]),
       seed=st.integers(0, 2 ** 16), scale=st.floats(0.1, 8.0))
def test_incremental_writes_match_bulk_within_requant_bound(kv_dtype, seed,
                                                            scale):
    """Token-by-token `write_token_quant` re-rounds the tail page against a
    growing abs-max; the final page stays within two quantization steps of
    the bulk-written one (plus fp8's relative mantissa step), and both saw
    the same abs-max (docs/serving.md's bound)."""
    page, hd = 8, 16
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        (rng.standard_normal((1, page, KV, hd)) * scale).astype(np.float32))
    table = torch.tensor([[0, -1, -1]], dtype=torch.int32)
    sdt = tpc.kv_storage_dtype(kv_dtype)

    def empty():
        return (torch.zeros((3, page, KV, hd), dtype=sdt),
                torch.ones((3, KV)))
    (bk, bks), (bv, bvs) = empty(), empty()
    tpc.write_prompt_quant(bk, bv, bks, bvs, table[0], x, x, page, kv_dtype)
    (ik, iks), (iv, ivs) = empty(), empty()
    for t in range(page):
        tpc.write_token_quant(ik, iv, iks, ivs, table,
                              torch.tensor([t], dtype=torch.int32),
                              x[:, t:t + 1], x[:, t:t + 1], kv_dtype)
    torch.testing.assert_close(iks[0], bks[0], rtol=1e-6, atol=0)
    dq_b = tpc.gather_sequence_dequant(bk, bks, table)[:, :page]
    dq_i = tpc.gather_sequence_dequant(ik, iks, table)[:, :page]
    step = bks[0][None, None, :, None]
    rel = 0.0 if kv_dtype == "int8" else 0.30
    assert bool(((dq_i - dq_b).abs()
                 <= 2.0 * step + rel * dq_b.abs() + 1e-6).all())
