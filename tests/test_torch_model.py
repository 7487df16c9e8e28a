"""The port's paged model entry points against the JAX package's on the
same weights and the same pool state: prefill_ragged_paged (with a padding
row), prefill_chunk_paged, decode_step_paged (with an inactive row) and
fork_slot_paged, on the test TINY config and the TINY cloud/edge fleet."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (CONFIGS, STACK_ATOL, assert_close, jax_config,
                           params_pair)
from repro.models import transformer as jt
from repro_torch.models import transformer as tt

B, N_PAGES, PAGE, P = 3, 14, 8, 6


def _caches(cfg, seed):
    """The same pre-filled pool state, lengths and block table on both
    sides: slot 0 holds 11 tokens, slot 1 holds 0, slot 2 holds 17 tokens
    and shares slot 0's first page (a COW fork)."""
    rng = np.random.default_rng(seed)
    tc = tt.init_paged_cache(cfg, B, N_PAGES, PAGE, P)
    jc = jt.init_paged_cache(jax_config(cfg), B, N_PAGES, PAGE, P)
    # the port's pools carry one scratch page; the JAX side takes the same
    # random pools, extra page included, as plain pages it never maps
    table = np.full((B, P), -1, np.int32)
    table[0, :3] = [4, 1, 9]
    table[1, :2] = [2, 7]
    table[2, :4] = [4, 3, 11, 12]
    lengths = np.array([11, 0, 17], np.int32)
    tc["block_table"].copy_(torch.from_numpy(table))
    tc["lengths"].copy_(torch.from_numpy(lengths))
    jc["block_table"], jc["lengths"] = jnp.asarray(table), jnp.asarray(lengths)
    for tseg, jseg in zip(tc["segments"], jc["segments"]):
        for k in ("k_pages", "v_pages"):
            a = rng.standard_normal(tuple(tseg[k].shape)).astype(np.float32)
            tseg[k].copy_(torch.from_numpy(a))
            jseg[k] = jnp.asarray(a)
    return tc, jc


def _same_cache(tc, jc):
    """Equal lengths and pools, apart from the port's scratch page (the
    last page of each pool, where dropped writes land)."""
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    for tseg, jseg in zip(tc["segments"], jc["segments"]):
        for k in ("k_pages", "v_pages"):
            assert_close(tseg[k][:, :-1], np.asarray(jseg[k])[:, :-1],
                         err_msg=k, atol=STACK_ATOL)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    cfg = CONFIGS[request.param]
    jp, tp = params_pair(cfg, seed=1)
    return cfg, jp, tp


def test_prefill_ragged_paged(setup):
    cfg, jp, tp = setup
    tc, jc = _caches(cfg, 0)
    rng = np.random.default_rng(1)
    C = 8
    toks = rng.integers(0, cfg.vocab_size, (4, C))
    slots = np.array([0, 2, 1, B], np.int32)      # last row pads
    offs = np.array([11, 17, 0, 0], np.int32)
    lens = np.array([5, 3, 8, 0], np.int32)
    tl, tc = tt.prefill_ragged_paged(cfg, tp, torch.from_numpy(toks), tc,
                                     slots, offs, lens, live_pages=4)
    jl, jc = jt.prefill_ragged_paged(jax_config(cfg), jp, jnp.asarray(toks),
                                     jc, slots, offs, lens, live_pages=4)
    assert_close(tl[:3], np.asarray(jl)[:3], atol=STACK_ATOL)
    _same_cache(tc, jc)


def test_prefill_chunk_paged(setup):
    cfg, jp, tp = setup
    tc, jc = _caches(cfg, 2)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 16))
    tl, tc = tt.prefill_chunk_paged(cfg, tp, torch.from_numpy(toks), tc, 0,
                                    11, 9, live_pages=4)
    jl, jc = jt.prefill_chunk_paged(jax_config(cfg), jp, jnp.asarray(toks),
                                    jc, 0, 11, 9, live_pages=4)
    assert_close(tl, jl, atol=STACK_ATOL)
    _same_cache(tc, jc)


@pytest.mark.parametrize("live_pages", [None, 4])
def test_decode_step_paged(setup, live_pages):
    cfg, jp, tp = setup
    tc, jc = _caches(cfg, 4)
    toks = np.array([[3], [9], [27]])
    active = np.array([True, False, True])
    tl, tc = tt.decode_step_paged(cfg, tp, torch.from_numpy(toks), tc,
                                  active=torch.from_numpy(active),
                                  live_pages=live_pages)
    jl, jc = jt.decode_step_paged(jax_config(cfg), jp, jnp.asarray(toks), jc,
                                  active=jnp.asarray(active),
                                  live_pages=live_pages)
    assert_close(tl[active], np.asarray(jl)[active], atol=STACK_ATOL)
    _same_cache(tc, jc)


def test_fork_slot_paged(setup):
    cfg, _, _ = setup
    tc, jc = _caches(cfg, 5)
    tc = tt.fork_slot_paged(cfg, tc, 0, 1, 9, 7)
    jc = jt.fork_slot_paged(jax_config(cfg), jc, 0, 1, 9, 7)
    _same_cache(tc, jc)
    tc = tt.fork_slot_paged(cfg, tc, 2, 2, 3, 3)       # page-aligned no-op
    jc = jt.fork_slot_paged(jax_config(cfg), jc, 2, 2, 3, 3)
    _same_cache(tc, jc)


def test_unsupported_configs_raise():
    base = CONFIGS["tiny"]
    for cfg in (base.with_(attn_logit_softcap=30.0),
                base.with_(sliding_window=16),
                base.with_(family="moe", n_experts=4, experts_per_token=2)):
        with pytest.raises(NotImplementedError):
            tt.init_paged_cache(cfg, 2, 4, 8, 2)
