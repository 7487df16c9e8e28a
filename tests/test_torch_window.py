"""The sliding-window ring cache of the port (mixtral-8x7b.reduced() in
float32 at capacity factor 8.0, so that no MoE assignment drops and calls
of different token counts route alike):

- the ring write of prefill against the JAX package's at prompts short of
  the window, and one-token decode through the plain version of the
  decode-attention kernel (#8) over the ring's first min(len + 1, w) rows
  against the JAX package's `attention_decode(window=w)`, before and after
  the ring wraps; several tokens at once through the plain ring mask;
- prefill + decode_step against the JAX package's through a wrapping
  ring, and the dense engine against the JAX engine at w = 64, where no
  prompt bucket of the JAX engine (32, 64) exceeds the window;
- the port's engine decode against its own teacher-forced `forward` at
  prompts padded past the window (w = 8, prompts of 12 and 37 tokens in
  buckets of 32 and 64). The JAX engine fails here: its prefill keeps the
  last w rows of the padded buffer, which drops real positions once the
  bucket exceeds the window (ROADMAP §3), and the port builds the ring
  from each prompt's own length.

Tolerance: the North star's (rtol 1e-5, atol 1e-6), logits at the end of
the stack at `_torch_common.STACK_ATOL`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (RTOL, STACK_ATOL, assert_close, assert_same_replay,
                           jax_config, params_pair, teacher_forced)
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.configs.registry import get_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import cache as cache_lib
from repro_torch.models import transformer as tt
from repro_torch.models.layers import apply_rope
from repro_torch.serving.engine import InferenceEngine

BASE = get_config("mixtral-8x7b").reduced(dtype="float32", remat=False,
                                          capacity_factor=8.0)


@pytest.fixture(scope="module")
def w64():
    cfg = BASE.with_(sliding_window=64)
    return (cfg,) + params_pair(cfg, seed=3)


@pytest.fixture(scope="module")
def w8():
    cfg = BASE.with_(sliding_window=8)
    return (cfg,) + params_pair(cfg, seed=4)


def test_ring_write_matches_jax_short_of_the_window(w64):
    """Prompts of 40 and 23 tokens in a 40-wide buffer (< w = 64): every
    ring row a position has reached holds the JAX package's K/V; the port
    zeroes the rest (the JAX package keeps the second prompt's padding
    there, which no read admits)."""
    cfg, jp, tp = w64
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 40))
    L = np.array([40, 23], np.int32)
    jc = jt.init_cache(jax_config(cfg), 2, 256)
    tc = tt.init_cache(cfg, 2, 256, device="cpu")
    jl, jc = jt.prefill(jax_config(cfg), jp, jnp.asarray(toks), jc,
                        prompt_lengths=jnp.asarray(L))
    tl, tc = tt.prefill(cfg, tp, torch.from_numpy(toks), tc, prompt_lengths=L)
    assert_close(tl, jl, atol=STACK_ATOL)
    for tseg, jseg in zip(tc["segments"], jc["segments"]):
        for k in ("k", "v"):
            assert tseg[k].shape[2] == 64
            for b, n in enumerate(L):
                assert_close(tseg[k][:, b, :n], np.asarray(jseg[k])[:, b, :n],
                             err_msg=k, atol=STACK_ATOL)
                assert not tseg[k][:, b, n:].any()


@pytest.mark.parametrize("T", [1, 3])
def test_decode_over_the_ring_matches_jax(w64, T):
    """One layer's attention_decode on a ring of random K/V at lengths
    before, at and past the window. One token: the port's write, then the
    decode-attention wrapper's plain version over min(len + 1, w) rows;
    several: `attention_decode`'s plain ring mask. Against the JAX
    package's `attention_decode(window=w)` (plain jnp): outputs and the
    ring after the write."""
    cfg, jp, tp = w64
    w = cfg.sliding_window
    rng = np.random.default_rng(1)
    lengths = np.array([0, 5, 62, 63, 64, 100, 200], np.int32)
    B = len(lengths)
    shape = (B, w, cfg.n_kv_heads, cfg.resolved_head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    jparams = jax.tree.map(lambda a: a[0], jp["segments"][0]["attn"])
    jout, jk, jv = jattn.attention_decode(
        jax_config(cfg), jparams, jnp.asarray(x), jnp.asarray(k0),
        jnp.asarray(v0), jnp.asarray(lengths), window=w)
    params = tp["segments"][0][0]["attn"]
    k, v = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    lens = torch.from_numpy(lengths)
    if T == 1:
        call = attn_lib.dense_decode_call(cfg, lens, 1, w)
        assert call.read_lens.tolist() == np.minimum(lengths + 1, w).tolist()
        q, nk, nv = attn_lib._project_qkv(cfg, params, torch.from_numpy(x))
        q = apply_rope(q, tables=call.rope)
        nk = apply_rope(nk, tables=call.rope)
        cache_lib.update_layer_kv(k, v, lens, nk, nv, call.dest)
        out = attn_lib._out_proj(params, da_ops.decode_attention(
            q, k, v, call.read_lens))
    else:
        out, k, v = attn_lib.attention_decode(cfg, params,
                                              torch.from_numpy(x), k, v, lens)
    # the plain version of #8 sums the ring's rows in row order, the JAX
    # mask in its own: float32 noise of 1e-6 on outputs of about 1 after
    # the output projection
    assert_close(out, jout, atol=STACK_ATOL)
    assert_close(k, jk)
    assert_close(v, jv)


def test_prefill_and_decode_through_a_wrapping_ring(w8):
    """Prompts of 6 and 4 tokens (a 6-wide buffer, short of w = 8), then
    14 decode steps: the ring wraps, and every step's logits equal the
    JAX package's."""
    cfg, jp, tp = w8
    jc_cfg = jax_config(cfg)
    toks = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 6))
    L = np.array([6, 4], np.int32)
    jc = jt.init_cache(jc_cfg, 2, 64)
    tc = tt.init_cache(cfg, 2, 64, device="cpu")
    jl, jc = jt.prefill(jc_cfg, jp, jnp.asarray(toks), jc,
                        prompt_lengths=jnp.asarray(L))
    tl, tc = tt.prefill(cfg, tp, torch.from_numpy(toks), tc, prompt_lengths=L)
    assert_close(tl, jl, atol=STACK_ATOL)
    for step in range(14):
        new = np.array([[7 + step], [30 + step]])
        jl, jc = jt.decode_step(jc_cfg, jp, jnp.asarray(new), jc)
        tl, tc = tt.decode_step(cfg, tp, torch.from_numpy(new), tc)
        assert_close(tl, jl, atol=STACK_ATOL, err_msg=f"step {step}")


def test_dense_engine_matches_jax_under_the_window(w64):
    cfg, jp, tp = w64
    prompts = [[65 + i for i in range(43)], [70, 71], [80] * 40, [9] * 17]
    kw = dict(max_batch=3, max_len=128, kv_backend="dense")
    want = JEngine(jax_config(cfg), jp, **kw).generate(prompts, max_new=30)
    got = InferenceEngine(cfg, tp, device="cpu", **kw).generate(prompts,
                                                                max_new=30)
    assert_same_replay(got, want)


@pytest.mark.parametrize("n", [12, 37])
def test_engine_decode_equals_forward_padded_past_the_window(w8, n):
    """A prompt of n tokens padded to its bucket (32 or 64), past w = 8:
    the engine's greedy tokens are teacher-forced `forward`'s argmax along
    them, and its logprobs `forward`'s log-softmax."""
    cfg, _, tp = w8
    prompt = [(5 * i + n) % 200 + 1 for i in range(n)]
    eng = InferenceEngine(cfg, tp, kv_backend="dense", max_batch=2,
                          max_len=128, device="cpu", eos_id=-1)
    toks, lps = eng.generate([prompt, prompt[:5]], max_new=12)[0]
    want_toks, want_lps = teacher_forced(cfg, tp, prompt, toks)
    assert toks == want_toks
    np.testing.assert_allclose(lps, want_lps, rtol=RTOL, atol=STACK_ATOL)


def test_read_width_stays_inside_the_ring(w8):
    cfg, _, tp = w8
    eng = InferenceEngine(cfg, tp, kv_backend="dense", max_batch=2,
                          max_len=128, device="cpu")
    assert eng.cache["segments"][0]["k"].shape[2] == 8
    eng.slots[0].ctx_len = 50
    assert eng._live_rows([0]) == 8
    eng.slots[0].ctx_len = 3
    assert eng._live_rows([0]) == 4
