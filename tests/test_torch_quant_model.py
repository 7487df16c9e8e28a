"""The port's paged model entry points over a quantized pool (int8, fp8)
against the JAX package's, started from the same quantized cache (the same
storage bytes and scales on both sides): decode_step_paged (with an
inactive row), prefill_chunk_paged (a chunk that starts mid-page) and
prefill_ragged_paged (with a padding row) on the 2-layer TINY config, and
fork_slot_paged copying the tail page's scales with the page.

Logits are held to the North-star tolerance (rtol 1e-5, atol 1e-6). The
two sides' f32 K/V differ by float noise, and an element that lies within
that noise of a rounding boundary may be stored one quantization step
apart: pools may differ by one step on at most `MAX_STEP_FLIPS` elements
(int8 codes by 1, e4m3 codes by one representable value), and scales,
which follow the pages' abs-max, within rtol 1e-5."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_common import TINY, assert_close, jax_config, params_pair
from repro.models import transformer as jt
from repro_torch.models import transformer as tt

B, N_PAGES, PAGE, P = 3, 14, 8, 6
MAX_STEP_FLIPS = 4                 # per pool tensor (all layers)


@pytest.fixture(scope="module", params=["int8", "fp8"])
def setup(request):
    cfg = TINY.with_(kv_dtype=request.param)
    jp, tp = params_pair(cfg, seed=1)
    return cfg, jp, tp


def _caches(cfg, seed):
    """The same quantized pool state, scales, lengths and block table on
    both sides: slot 0 holds 11 tokens, slot 1 holds 0, slot 2 holds 17
    tokens and shares slot 0's first page (a COW fork). The JAX side takes
    the port's scratch page as a plain page it never maps."""
    rng = np.random.default_rng(seed)
    tc = tt.init_paged_cache(cfg, B, N_PAGES, PAGE, P, device="cpu")
    jc = jt.init_paged_cache(jax_config(cfg), B, N_PAGES, PAGE, P)
    table = np.full((B, P), -1, np.int32)
    table[0, :3] = [4, 1, 9]
    table[1, :2] = [2, 7]
    table[2, :4] = [4, 3, 11, 12]
    lengths = np.array([11, 0, 17], np.int32)
    tc["block_table"].copy_(torch.from_numpy(table))
    tc["lengths"].copy_(torch.from_numpy(lengths))
    jc["block_table"], jc["lengths"] = jnp.asarray(table), jnp.asarray(lengths)
    store = (np.int8 if cfg.kv_dtype == "int8" else ml_dtypes.float8_e4m3fn)
    for tseg, jseg in zip(tc["segments"], jc["segments"]):
        for k in ("k_pages", "v_pages"):
            f = rng.uniform(-120, 120, tuple(tseg[k].shape))
            raw = f.astype(np.float32).astype(store)
            tseg[k].view(torch.uint8).copy_(
                torch.from_numpy(raw.view(np.uint8)))
            jseg[k] = jnp.asarray(raw)
        for k in ("k_scale", "v_scale"):
            s = (rng.random(tuple(tseg[k].shape)) * 0.02 + 0.005).astype(
                np.float32)
            tseg[k].copy_(torch.from_numpy(s))
            jseg[k] = jnp.asarray(s)
    return tc, jc


def _steps_apart(a, b, kv_dtype):
    """Quantization steps between two stored arrays of codes."""
    if kv_dtype == "int8":
        return np.abs(a.view(np.int8).astype(np.int32)
                      - b.view(np.int8).astype(np.int32))
    # e4m3fn codes of one sign are ordered like their values: the step
    # count is the code distance (a sign flip only between +-0 and the
    # smallest subnormals, which the value check below bounds)
    va = a.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    vb = b.view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    same_sign = np.sign(va) == np.sign(vb)
    code = np.abs(a.astype(np.int32) & 0x7F) - (b.astype(np.int32) & 0x7F)
    return np.where(same_sign | (np.maximum(np.abs(va), np.abs(vb)) <= 2.0
                                 ** -6), np.abs(code), 99)


def _same_cache(tc, jc, kv_dtype):
    """Equal lengths; pools within one step on at most MAX_STEP_FLIPS
    elements and scales within rtol 1e-5, apart from the port's scratch
    page and its scale row."""
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    for tseg, jseg in zip(tc["segments"], jc["segments"]):
        for k in ("k_pages", "v_pages"):
            a = tseg[k].view(torch.uint8).numpy()[:, :-1]
            b = np.asarray(jseg[k]).view(np.uint8)[:, :-1]
            steps = _steps_apart(a, b, kv_dtype)
            assert steps.max() <= 1, f"{k}: {steps.max()} steps apart"
            assert (steps > 0).sum() <= MAX_STEP_FLIPS, \
                f"{k}: {(steps > 0).sum()} elements one step apart"
        for k in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tseg[k].numpy()[:, :-1],
                                       np.asarray(jseg[k])[:, :-1],
                                       rtol=1e-5, atol=0, err_msg=k)


def test_prefill_ragged_paged_quant(setup):
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
    assert_close(tl[:3], np.asarray(jl)[:3])
    _same_cache(tc, jc, cfg.kv_dtype)


def test_prefill_chunk_paged_quant(setup):
    cfg, jp, tp = setup
    tc, jc = _caches(cfg, 2)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 16))
    tl, tc = tt.prefill_chunk_paged(cfg, tp, torch.from_numpy(toks), tc, 0,
                                    11, 9, live_pages=4)
    jl, jc = jt.prefill_chunk_paged(jax_config(cfg), jp, jnp.asarray(toks),
                                    jc, 0, 11, 9, live_pages=4)
    assert_close(tl, jl)
    _same_cache(tc, jc, cfg.kv_dtype)


@pytest.mark.parametrize("live_pages", [None, 4])
def test_decode_step_paged_quant(setup, live_pages):
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
    assert_close(tl[active], np.asarray(jl)[active])
    _same_cache(tc, jc, cfg.kv_dtype)


def test_prefill_paged_quant(setup):
    """Monolithic prefill writes the prompt through `write_prompt_quant`
    (its attention runs on the unquantized K/V, as in the JAX package)."""
    cfg, jp, tp = setup
    tc, jc = _caches(cfg, 6)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 16))
    tl, tc = tt.prefill_paged(cfg, tp, torch.from_numpy(toks), tc, 1, 13)
    jl, jc = jt.prefill_paged(jax_config(cfg), jp, jnp.asarray(toks), jc, 1,
                              13)
    assert_close(tl, jl)
    _same_cache(tc, jc, cfg.kv_dtype)


def test_fork_copies_tail_page_scales(setup):
    """The COW tail page's scales move with it; a page-aligned fork copies
    nothing."""
    cfg, _, _ = setup
    tc, jc = _caches(cfg, 5)
    tc = tt.fork_slot_paged(cfg, tc, 0, 1, 9, 7)
    jc = jt.fork_slot_paged(jax_config(cfg), jc, 0, 1, 9, 7)
    _same_cache(tc, jc, cfg.kv_dtype)
    for seg in tc["segments"]:
        for k in ("k_scale", "v_scale"):
            torch.testing.assert_close(seg[k][:, 7], seg[k][:, 9], rtol=0,
                                       atol=0)
        for k in ("k_pages", "v_pages"):
            assert torch.equal(seg[k][:, 7].view(torch.uint8),
                               seg[k][:, 9].view(torch.uint8))
    before = [seg["k_scale"].clone() for seg in tc["segments"]]
    tc = tt.fork_slot_paged(cfg, tc, 2, 2, 3, 3)       # page-aligned no-op
    for seg, was in zip(tc["segments"], before):
        assert torch.equal(seg["k_scale"], was)


def test_init_paged_cache_quant_leaves(setup):
    cfg, _, _ = setup
    tc = tt.init_paged_cache(cfg, B, N_PAGES, PAGE, P, device="cpu")
    for seg in tc["segments"]:
        assert seg["k_pages"].dtype == (torch.int8 if cfg.kv_dtype == "int8"
                                        else torch.float8_e4m3fn)
        for k in ("k_scale", "v_scale"):
            assert seg[k].shape == (seg["k_pages"].shape[0], N_PAGES + 1,
                                    cfg.n_kv_heads)
            assert seg[k].dtype == torch.float32 and bool((seg[k] == 1).all())
