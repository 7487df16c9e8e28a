"""The three paged-attention wrappers of the port on CPU tensors (their
plain versions) against the JAX package's Pallas kernels in interpret mode
and its ref.py oracles, on the case families of tests/test_paged_kernel.py:
ragged lengths including 0, unmapped -1 tail pages, COW-shared page ids
across rows, padding ingest rows, and the head_dim / q_per_kv / page / C
sets of the serving path. A CPU tensor counts no kernel launch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (thread count)
from repro.kernels.paged_decode_attention import ops as jdops
from repro.kernels.paged_decode_attention import ref as jdref
from repro.kernels.paged_prefill_attention import ops as jpops
from repro.kernels.paged_prefill_attention import ref as jpref
from repro_torch.kernels.paged_decode_attention import ops as dops
from repro_torch.kernels.paged_prefill_attention import ops as pops

TOL = dict(rtol=2e-5, atol=2e-5)       # tests/test_paged_kernel.py, f32


def _chained_table(lens, page, P, start=0):
    tbl = np.full((len(lens), P), -1, np.int32)
    nxt = start
    for b, ln in enumerate(lens):
        live = -(-int(ln) // page)
        tbl[b, :live] = np.arange(nxt, nxt + live)
        nxt += live
    return tbl


def _pools(rng, n_pages, page, Hkv, hd):
    return (rng.standard_normal((n_pages, page, Hkv, hd)).astype(np.float32),
            rng.standard_normal((n_pages, page, Hkv, hd)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# (B, Hq, Hkv, hd, page, P): q_per_kv 1, 2, 4, 6; head_dim 24, 32, 128
DECODE_CASES = [(3, 8, 2, 32, 8, 6), (2, 4, 4, 24, 16, 4),
                (3, 12, 2, 128, 32, 3), (2, 8, 2, 32, 16, 5)]


@pytest.mark.parametrize("B,Hq,Hkv,hd,page,P", DECODE_CASES)
def test_paged_decode_plain_vs_pallas(B, Hq, Hkv, hd, page, P):
    rng = np.random.default_rng(hd + page)
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    kp, vp = _pools(rng, B * P + 2, page, Hkv, hd)
    lens = rng.integers(1, P * page + 1, B).astype(np.int32)
    lens[0] = 0                                 # a length-0 slot
    lens[-1] = page + page // 2                 # a mid-page partial length
    table = _chained_table(lens, page, P)       # -1 tail pages
    before = dops.paged_decode_attention.launches
    got = dops.paged_decode_attention(*_t(q, kp, vp, table, lens))
    assert dops.paged_decode_attention.launches == before
    pallas = jdops.paged_decode_attention(*_j(q, kp, vp, table, lens),
                                          interpret=True)
    oracle = jdref.paged_decode_attention_ref(*_j(q, kp, vp, table, lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    np.testing.assert_array_equal(got[0].numpy(), 0.0)


def test_paged_decode_cow_shared_pages():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 1, 8, 32)).astype(np.float32)
    kp, vp = _pools(rng, 12, 8, 2, 32)
    table = np.array([[0, 1, 2, -1], [0, 1, 3, 4]], np.int32)
    lens = np.array([20, 28], np.int32)
    got = dops.paged_decode_attention(*_t(q, kp, vp, table, lens))
    pallas = jdops.paged_decode_attention(*_j(q, kp, vp, table, lens),
                                          interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


# (Hq, Hkv, hd, page, C)
PREFILL_CASES = [(8, 2, 32, 8, 16), (4, 4, 24, 16, 48),
                 (12, 2, 128, 32, 16), (8, 2, 32, 16, 64)]


@pytest.mark.parametrize("Hq,Hkv,hd,page,C", PREFILL_CASES)
def test_paged_prefill_ragged_plain_vs_pallas(Hq, Hkv, hd, page, C):
    rng = np.random.default_rng(C + hd)
    P = -(-(2 * C + page) // page)
    # rows: a mid-prompt chunk, a first chunk, a short tail chunk, padding
    offs = np.array([C, 0, page + 3, 0], np.int32)
    lens = np.array([C, C // 2, 5, 0], np.int32)
    R = len(offs)
    table = _chained_table(offs + lens, page, P)
    table[1, :2] = table[0, :2]                 # COW-shared prefix pages
    kp, vp = _pools(rng, int(table.max()) + 3, page, Hkv, hd)
    q = rng.standard_normal((R, C, Hq, hd)).astype(np.float32)
    before = pops.paged_prefill_attention_ragged.launches
    got = pops.paged_prefill_attention_ragged(*_t(q, kp, vp, table, offs,
                                                  lens))
    assert pops.paged_prefill_attention_ragged.launches == before
    pallas = jpops.paged_prefill_attention_ragged(
        *_j(q, kp, vp, table, offs, lens), interpret=True)
    oracle = jpref.paged_prefill_attention_ragged_ref(
        *_j(q, kp, vp, table, offs, lens))
    for r in range(R):                          # rows past lens unspecified
        n = lens[r]
        np.testing.assert_allclose(got[r, :n].numpy(),
                                   np.asarray(pallas)[r, :n], **TOL)
        np.testing.assert_allclose(got[r, :n].numpy(),
                                   np.asarray(oracle)[r, :n], **TOL)


@pytest.mark.parametrize("offset,chunk_len", [(0, 16), (21, 9), (40, 1)])
def test_paged_prefill_single_slot_plain_vs_pallas(offset, chunk_len):
    rng = np.random.default_rng(offset)
    C, Hq, Hkv, hd, page, P = 16, 8, 2, 32, 8, 8
    kp, vp = _pools(rng, 12, page, Hkv, hd)
    row = np.array([3, 7, 1, 9, 0, 5, 2, -1], np.int32)
    q = rng.standard_normal((1, C, Hq, hd)).astype(np.float32)
    before = pops.paged_prefill_attention.launches
    got = pops.paged_prefill_attention(*_t(q, kp, vp, row), offset, chunk_len)
    assert pops.paged_prefill_attention.launches == before
    pallas = jpops.paged_prefill_attention(
        *_j(q, kp, vp, row), jnp.int32(offset), jnp.int32(chunk_len),
        interpret=True)
    oracle = jpref.paged_prefill_attention_ref(
        *_j(q, kp, vp, row), jnp.int32(offset), jnp.int32(chunk_len))
    np.testing.assert_allclose(got[0, :chunk_len].numpy(),
                               np.asarray(pallas)[0, :chunk_len], **TOL)
    np.testing.assert_allclose(got[0, :chunk_len].numpy(),
                               np.asarray(oracle)[0, :chunk_len], **TOL)


def test_wrappers_refuse_mixed_devices():
    from repro_torch.kernels import runtime
    with pytest.raises(ValueError):
        runtime.use_kernel(torch.zeros(1), torch.zeros(1, device="meta"))


@pytest.mark.parametrize("B,Hkv,P", [(8, 8, 16), (8, 2, 16), (1, 8, 32),
                                     (3, 2, 6), (66, 8, 3), (2, 2, 1),
                                     (4, 2, 0), (1, 2, 32), (1, 8, 256)])
def test_decode_splits_cover_the_table(B, Hkv, P):
    """The split planner: every block-table column has a block, no block is
    empty, and the splits of one (slot, kv head), which merge inside one
    thread-block cluster, are at most the cluster size."""
    from repro_torch.kernels.paged_decode_attention.kernel import (
        BLOCKS_PER_SM, MAX_SPLITS, split_pages)
    n_sm = 132
    splits, per = split_pages(B, Hkv, P, n_sm)
    assert splits >= 1 and per >= 1
    assert splits * per >= P                    # every column has a block
    assert (splits - 1) * per < max(P, 1)       # and no block is empty
    assert splits <= MAX_SPLITS                 # one cluster
    if B * Hkv * P <= BLOCKS_PER_SM * n_sm and P <= MAX_SPLITS:
        assert per == 1                         # small grids: page per block
    if B * Hkv >= BLOCKS_PER_SM * n_sm:
        assert splits == 1                      # the slots alone fill it


@pytest.mark.parametrize("page,hd", [(0, 32), (65, 32), (16, 0), (16, 260),
                                     (16, 26)])
def test_kernel_limits_raise(page, hd):
    from repro_torch.kernels import runtime
    with pytest.raises(ValueError):
        runtime.check_limits(page, hd)


@pytest.mark.parametrize("overrides", [dict(head_dim=26), dict(head_dim=512)])
def test_validate_paged_refuses_what_the_kernels_do_not_take(overrides):
    from _torch_common import TINY
    with pytest.raises(ValueError):
        TINY.with_(**overrides).validate_paged(16, 128)
