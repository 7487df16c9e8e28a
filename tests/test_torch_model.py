"""The port's paged model entry points against the JAX package's on the
same weights and the same pool state: prefill_ragged_paged (with a padding
row), prefill_chunk_paged, decode_step_paged (with an inactive row) and
fork_slot_paged, on the test TINY config and the TINY cloud/edge fleet."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (B, CONFIGS, STACK_ATOL, assert_close,
                           assert_same_pools, jax_config, paged_caches,
                           params_pair)
from repro.models import transformer as jt
from repro_torch.models import transformer as tt


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    cfg = CONFIGS[request.param]
    jp, tp = params_pair(cfg, seed=1)
    return cfg, jp, tp


def test_prefill_ragged_paged(setup):
    cfg, jp, tp = setup
    tc, jc = paged_caches(cfg, 0)
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
    assert_same_pools(tc, jc)


def test_prefill_chunk_paged(setup):
    cfg, jp, tp = setup
    tc, jc = paged_caches(cfg, 2)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 16))
    tl, tc = tt.prefill_chunk_paged(cfg, tp, torch.from_numpy(toks), tc, 0,
                                    11, 9, live_pages=4)
    jl, jc = jt.prefill_chunk_paged(jax_config(cfg), jp, jnp.asarray(toks),
                                    jc, 0, 11, 9, live_pages=4)
    assert_close(tl, jl, atol=STACK_ATOL)
    assert_same_pools(tc, jc)


@pytest.mark.parametrize("live_pages", [None, 4])
def test_decode_step_paged(setup, live_pages):
    cfg, jp, tp = setup
    tc, jc = paged_caches(cfg, 4)
    toks = np.array([[3], [9], [27]])
    active = np.array([True, False, True])
    tl, tc = tt.decode_step_paged(cfg, tp, torch.from_numpy(toks), tc,
                                  active=torch.from_numpy(active),
                                  live_pages=live_pages)
    jl, jc = jt.decode_step_paged(jax_config(cfg), jp, jnp.asarray(toks), jc,
                                  active=jnp.asarray(active),
                                  live_pages=live_pages)
    assert_close(tl[active], np.asarray(jl)[active], atol=STACK_ATOL)
    assert_same_pools(tc, jc)


def test_fork_slot_paged(setup):
    cfg, _, _ = setup
    tc, jc = paged_caches(cfg, 5)
    tc = tt.fork_slot_paged(cfg, tc, 0, 1, 9, 7)
    jc = jt.fork_slot_paged(jax_config(cfg), jc, 0, 1, 9, 7)
    assert_same_pools(tc, jc)
    tc = tt.fork_slot_paged(cfg, tc, 2, 2, 3, 3)       # page-aligned no-op
    jc = jt.fork_slot_paged(jax_config(cfg), jc, 2, 2, 3, 3)
    assert_same_pools(tc, jc)


def test_unsupported_configs_raise():
    """The paged cache refuses a softcap and a window, as the JAX package's
    does, and cross-attention caches (an encoder-decoder), which the JAX
    package's paged cache refuses too."""
    base = CONFIGS["tiny"]
    for cfg in (base.with_(attn_logit_softcap=30.0),
                base.with_(sliding_window=16),
                base.with_(family="encdec")):
        with pytest.raises(NotImplementedError):
            tt.init_paged_cache(cfg, 2, 4, 8, 2)
