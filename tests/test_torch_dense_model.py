"""The port's dense-cache and monolithic model entry points against the JAX
package's, on the same weights and inputs: `update_layer_kv` (the clamped
write at capacity), the plain attention helpers, `attention_fwd` /
`attention_decode`, `forward` (with the JAX side's use_pallas off and on),
dense `prefill` and `decode_step` (an inactive row still writes and does
not advance), and monolithic `prefill_paged`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (CONFIGS, STACK_ATOL, TINY, assert_close,
                           assert_same_pools, jax_config, paged_caches,
                           params_pair)
from repro.models import attention as ja
from repro.models import cache as jcache
from repro.models import transformer as jt
from repro_torch.models import attention as ta
from repro_torch.models import cache as tcache
from repro_torch.models import transformer as tt

RNG = np.random.default_rng(0)


def _x(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    cfg = CONFIGS[request.param]
    jp, tp = params_pair(cfg, seed=2)
    return cfg, jp, tp


# ---------------------------------------------------------------------------
# cache writes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 3])
def test_update_layer_kv_clamps_at_capacity(T):
    """Slots at lengths 0, mid-cache, S - T + 1 and S: the last two are
    clamped so the T rows fit, overwriting the cache's last rows."""
    S = 10
    k, v = _x(4, S, 2, 8), _x(4, S, 2, 8)
    nk, nv = _x(4, T, 2, 8), _x(4, T, 2, 8)
    lens = np.array([0, 4, S - T + 1, S], np.int32)
    tk, tv = tcache.update_layer_kv(*[torch.from_numpy(a.copy())
                                      for a in (k, v, lens, nk, nv)])
    jk, jv = jcache.update_layer_kv(*[jnp.asarray(a)
                                      for a in (k, v, lens, nk, nv)])
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_window_ring_is_not_ported():
    """(Named for the refusal it checked before the ring was ported.) The
    ring of a window W holds W rows whatever max_len is, and its writes
    wrap, as the JAX package's `update_layer_kv(window=W)` does."""
    W, T = 4, 2
    ring = tcache.init_kv_cache(1, 1, 8, 1, 8, window=W)
    assert ring["k"].shape == jcache.init_kv_cache(1, 1, 8, 1, 8,
                                                   window=W)["k"].shape
    c = tt.init_cache(TINY.with_(sliding_window=16), 1, 64)
    assert c["segments"][0]["k"].shape[2] == 16
    k, v = _x(4, W, 2, 8), _x(4, W, 2, 8)
    nk, nv = _x(4, T, 2, 8), _x(4, T, 2, 8)
    lens = np.array([0, 3, 5, 9], np.int32)
    dest = tcache.write_plan(torch.from_numpy(lens), T, W, window=W)
    tk, tv = tcache.update_layer_kv(*[torch.from_numpy(a.copy())
                                      for a in (k, v, lens, nk, nv)],
                                    dest=dest)
    jk, jv = jcache.update_layer_kv(*[jnp.asarray(a)
                                      for a in (k, v, lens, nk, nv)],
                                    window=W)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# plain attention helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,softcap", [(0, 0.0), (8, 0.0), (0, 20.0)])
def test_full_and_chunked_sdpa(window, softcap, monkeypatch):
    """Both the dense branch and the q-blocked branch (forced by a small
    threshold and block, with and without the window slice)."""
    q, k, v = _x(2, 48, 4, 16), _x(2, 48, 4, 16), _x(2, 48, 4, 16)
    lens = np.array([48, 30], np.int32)
    kw = dict(causal=True, window=window, softcap=softcap)
    args_t = [torch.from_numpy(a) for a in (q, k, v)]
    args_j = [jnp.asarray(a) for a in (q, k, v)]
    assert_close(ta.full_or_chunked_sdpa(*args_t, kv_lengths=torch.from_numpy(
        lens), **kw), ja.full_or_chunked_sdpa(*args_j, kv_lengths=jnp.asarray(
            lens), **kw))
    for mod in (ta, ja):
        monkeypatch.setattr(mod, "CHUNK_THRESHOLD", 1)
        monkeypatch.setattr(mod, "CHUNK_BQ", 16)
    assert_close(ta.full_or_chunked_sdpa(*args_t, kv_lengths=torch.from_numpy(
        lens), **kw), ja.full_or_chunked_sdpa(*args_j, kv_lengths=jnp.asarray(
            lens), **kw))


def test_grouped_sdpa_and_causal_mask():
    q, k, v = _x(2, 5, 6, 8), _x(2, 9, 2, 8), _x(2, 9, 2, 8)
    tmask = ta.causal_mask(5, 9, q_offset=4, window=3)
    jmask = ja.causal_mask(5, 9, q_offset=4, window=3)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert_close(ta._grouped_sdpa(*[torch.from_numpy(a) for a in (q, k, v)],
                                  tmask, 3, 10.0),
                 ja._grouped_sdpa(*[jnp.asarray(a) for a in (q, k, v)],
                                  jmask, 3, 10.0))


# ---------------------------------------------------------------------------
# attention entry points
# ---------------------------------------------------------------------------

def _layer(jp, tp):
    return jax.tree.map(lambda a: a[0], jp["segments"][0]), tp["segments"][0][0]


@pytest.mark.parametrize("window,softcap,causal", [(0, 0.0, True),
                                                   (16, 30.0, True),
                                                   (0, 0.0, False)])
def test_attention_fwd(window, softcap, causal):
    cfg = TINY.with_(sliding_window=window, attn_logit_softcap=softcap)
    jl, tl = _layer(*params_pair(cfg, seed=3))
    x = _x(2, 24, cfg.d_model)
    pos = np.arange(24)[None]
    got = ta.attention_fwd(cfg, tl["attn"], torch.from_numpy(x),
                           torch.from_numpy(pos), causal=causal)
    want = ja.attention_fwd(jax_config(cfg), jl["attn"], jnp.asarray(x),
                            jnp.asarray(pos), causal=causal)
    assert_close(got, want)


def test_attention_fwd_segment_mask():
    jl, tl = _layer(*params_pair(TINY, seed=3))
    x = _x(1, 12, TINY.d_model)
    pos = np.arange(12)[None]
    seg = np.arange(12) // 5
    mask = (seg[:, None] == seg[None, :])[None, None]
    got = ta.attention_fwd(TINY, tl["attn"], torch.from_numpy(x),
                           torch.from_numpy(pos),
                           segment_mask=torch.from_numpy(mask))
    want = ja.attention_fwd(jax_config(TINY), jl["attn"], jnp.asarray(x),
                            jnp.asarray(pos), segment_mask=jnp.asarray(mask))
    assert_close(got, want)


@pytest.mark.parametrize("T", [1, 3])
def test_attention_decode(T):
    """One token reads through the decode wrapper, several through the
    plain grouped softmax; a slot at capacity writes its clamped row."""
    cfg = CONFIGS["tiny-edge-b"]
    jl, tl = _layer(*params_pair(cfg, seed=4))
    S, hd = 16, cfg.resolved_head_dim
    k, v = _x(3, S, cfg.n_kv_heads, hd), _x(3, S, cfg.n_kv_heads, hd)
    x = _x(3, T, cfg.d_model)
    lens = np.array([5, 0, S], np.int32)
    tout, tk, tv = ta.attention_decode(
        cfg, tl["attn"], torch.from_numpy(x), torch.from_numpy(k.copy()),
        torch.from_numpy(v.copy()), torch.from_numpy(lens))
    jout, jk, jv = ja.attention_decode(
        jax_config(cfg), jl["attn"], jnp.asarray(x), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(lens))
    assert_close(tout, jout)
    assert_close(tk, jk)
    assert_close(tv, jv)


def test_decode_softcap_raises():
    """The JAX package's kernel path drops the softcap on one-token decode;
    the port refuses it instead (ROADMAP §3)."""
    cfg = TINY.with_(attn_logit_softcap=30.0)
    _, tl = _layer(*params_pair(TINY, seed=4))
    k = torch.zeros(1, 8, TINY.n_kv_heads, TINY.resolved_head_dim)
    with pytest.raises(NotImplementedError):
        ta.attention_decode(cfg, tl["attn"], torch.zeros(1, 1, TINY.d_model),
                            k, k.clone(), torch.zeros(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward(setup, use_pallas):
    cfg, jp, tp = setup
    toks = RNG.integers(0, cfg.vocab_size, (2, 20))
    tl, taux = tt.forward(cfg, tp, torch.from_numpy(toks))
    jl, jaux = jt.forward(jax_config(cfg.with_(use_pallas=use_pallas)), jp,
                          jnp.asarray(toks))
    assert_close(tl, jl, atol=STACK_ATOL)
    assert float(taux) == float(jaux) == 0.0


def _dense_caches(cfg, B, S, seed):
    """The same random dense cache state on both sides."""
    rng = np.random.default_rng(seed)
    tc = tt.init_cache(cfg, B, S)
    jc = jt.init_cache(jax_config(cfg), B, S)
    for tseg, jseg in zip(tc["segments"], jc["segments"]):
        for k in ("k", "v"):
            a = rng.standard_normal(tuple(tseg[k].shape)).astype(np.float32)
            tseg[k].copy_(torch.from_numpy(a))
            jseg[k] = jnp.asarray(a)
    return tc, jc


def _same_dense_cache(tc, jc):
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    for tseg, jseg in zip(tc["segments"], jc["segments"]):
        for k in ("k", "v"):
            assert_close(tseg[k], jseg[k], err_msg=k, atol=STACK_ATOL)


def test_prefill(setup):
    """Right-padded prompts fill the rows, zeros past S (the random cache
    state past S is cleared, as the JAX package's fresh cache is zero)."""
    cfg, jp, tp = setup
    toks = RNG.integers(0, cfg.vocab_size, (2, 16))
    plens = np.array([16, 9], np.int32)
    tc, _ = _dense_caches(cfg, 2, 24, 5)
    jc = jt.init_cache(jax_config(cfg), 2, 24)
    tl, tc = tt.prefill(cfg, tp, torch.from_numpy(toks), tc,
                        torch.from_numpy(plens))
    jl, jc = jt.prefill(jax_config(cfg), jp, jnp.asarray(toks), jc,
                        prompt_lengths=jnp.asarray(plens))
    assert_close(tl, jl, atol=STACK_ATOL)
    _same_dense_cache(tc, jc)


def test_decode_step_inactive_row(setup):
    """Row 1 is inactive: it still writes at its length and does not
    advance; row 2 sits at capacity and writes its clamped last row."""
    cfg, jp, tp = setup
    tc, jc = _dense_caches(cfg, 3, 20, 6)
    lens = np.array([7, 3, 20], np.int32)
    tc["lengths"].copy_(torch.from_numpy(lens))
    jc["lengths"] = jnp.asarray(lens)
    toks = np.array([[3], [9], [27]])
    active = np.array([True, False, True])
    tl, tc = tt.decode_step(cfg, tp, torch.from_numpy(toks), tc,
                            active=torch.from_numpy(active))
    jl, jc = jt.decode_step(jax_config(cfg), jp, jnp.asarray(toks), jc,
                            active=jnp.asarray(active))
    assert_close(tl, jl, atol=STACK_ATOL)
    _same_dense_cache(tc, jc)
    assert tc["lengths"].tolist() == [8, 3, 21]


@pytest.mark.parametrize("live_rows", [13, 20])
def test_decode_step_live_rows(setup, live_rows):
    """The engine's narrowed read (every row's length + 1 <= live_rows)
    gives the JAX package's full-cache decode."""
    cfg, jp, tp = setup
    tc, jc = _dense_caches(cfg, 3, 20, 8)
    lens = np.array([7, 12, 0], np.int32)
    tc["lengths"].copy_(torch.from_numpy(lens))
    jc["lengths"] = jnp.asarray(lens)
    toks = np.array([[5], [11], [2]])
    tl, tc = tt.decode_step(cfg, tp, torch.from_numpy(toks), tc,
                            live_rows=live_rows)
    jl, jc = jt.decode_step(jax_config(cfg), jp, jnp.asarray(toks), jc)
    assert_close(tl, jl, atol=STACK_ATOL)
    _same_dense_cache(tc, jc)


def test_prefill_paged(setup):
    """One padded prompt into slot 1's pages; the padding is dropped (the
    port's scratch page) and the other slots' pages are untouched."""
    cfg, jp, tp = setup
    tc, jc = paged_caches(cfg, 7)
    table = np.asarray(jc["block_table"]).copy()
    table[1, :3] = [5, 13, 6]
    tc["block_table"].copy_(torch.from_numpy(table))
    jc["block_table"] = jnp.asarray(table)
    toks = RNG.integers(0, cfg.vocab_size, (1, 32))
    tl, tc = tt.prefill_paged(cfg, tp, torch.from_numpy(toks), tc, 1, 19)
    jl, jc = jt.prefill_paged(jax_config(cfg), jp, jnp.asarray(toks), jc, 1,
                              19)
    assert_close(tl, jl, atol=STACK_ATOL)
    assert_same_pools(tc, jc)
