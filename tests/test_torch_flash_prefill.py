"""Monolithic prefill through the flash kernel, and every norm through the
RMSNorm wrapper, checked on CPU tensors (the kernels' plain versions).

On the card `attention.prefill_attention` sends monolithic prefill to the
flash wrapper, which takes no prompt lengths: causal masking alone keeps
each row below its prompt's length from the right padding. These tests hold
that premise where the CPU can: the flash plain version's valid rows equal
the length-masked plain attention's (and the JAX package's flash kernel in
interpret mode), and a whole prefill sent down the flash path on the CPU
gives the same logits and the same cache rows below each length as the
plain path. Inputs come from numpy seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import CONFIGS, SSM_CONFIGS, TINY
from repro.kernels.flash_attention import ops as jfops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt

VALID_TOL = dict(rtol=1e-5, atol=1e-6)
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py, f32
LENGTHS = np.array([5, 17, 32], np.int32)


def _valid(a, lens):
    """Rows (b, s) with s < lens[b] of a (B, S, ...) array."""
    S = a.shape[1]
    return a[np.arange(S)[None, :] < lens[:, None]]


@pytest.mark.parametrize("Hq,Hkv", [(2, 2), (8, 2), (6, 1)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (8, 0.0), (0, 30.0),
                                            (8, 30.0)])
def test_flash_valid_rows_equal_length_masked(Hq, Hkv, window, softcap):
    """B 3, S 32, prompts of 5 / 17 / 32 right-padded, q_per_kv 1 / 4 / 6:
    causal flash without lengths equals the plain attention masked by the
    lengths on every row below its prompt's length."""
    rng = np.random.default_rng(Hq * 10 + window + int(softcap))
    B, S, hd = 3, 32, 16
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    flash = fref.flash_attention_ref(tq, tk, tv, causal=True, window=window,
                                     softcap=softcap).numpy()
    rep = Hq // Hkv
    masked = ta.full_or_chunked_sdpa(
        tq, ta._repeat_kv(tk, rep), ta._repeat_kv(tv, rep), causal=True,
        window=window, kv_lengths=torch.from_numpy(LENGTHS),
        softcap=softcap).numpy()
    np.testing.assert_allclose(_valid(flash, LENGTHS),
                               _valid(masked, LENGTHS), **VALID_TOL)
    jax_flash = np.asarray(jfops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, softcap=softcap, block_q=16, block_kv=16,
        interpret=True))
    np.testing.assert_allclose(_valid(flash, LENGTHS),
                               _valid(jax_flash, LENGTHS), **KERNEL_TOL)


def _flash_path(cfg, q, k, v, prompt_lengths):
    """`prefill_attention` as it runs on the card: the flash wrapper, no
    lengths (its plain version on these CPU tensors)."""
    return fops.flash_attention(q, k, v, causal=True,
                                window=cfg.sliding_window,
                                softcap=cfg.attn_logit_softcap)


def _dense_prefill(cfg, params, toks, plens):
    cache = tt.init_cache(cfg, len(toks), 40)
    logits, cache = tt.prefill(cfg, params, torch.from_numpy(toks), cache,
                               torch.from_numpy(plens))
    return logits, [(seg["k"], seg["v"]) for seg in cache["segments"]]


def _paged_prefill(cfg, params, toks, plens):
    """Each prompt into its own slot's pages (8 rows a page)."""
    B, S = toks.shape
    pages = -(-S // 8)
    cache = tt.init_paged_cache(cfg, B, B * pages, 8, pages)
    cache["block_table"].copy_(torch.arange(B * pages, dtype=torch.int32)
                               .reshape(B, pages))
    logits = []
    for b in range(B):
        lg, cache = tt.prefill_paged(cfg, params,
                                     torch.from_numpy(toks[b:b + 1]), cache,
                                     b, int(plens[b]))
        logits.append(lg)
    rows = [(seg["k_pages"], seg["v_pages"]) for seg in cache["segments"]]
    return torch.cat(logits), rows


@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_through_flash_equals_plain(name, backend, monkeypatch):
    """Right-padded prompts (lengths 5 / 17 / 32 in S 32): the flash path
    gives the plain path's logits and the same K/V at every position below
    each prompt's length (dense cache rows; paged: every page but the
    scratch page, where the padding goes)."""
    cfg = CONFIGS[name]
    params = tt.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (3, 32))
    run = _dense_prefill if backend == "dense" else _paged_prefill
    want_logits, want_kv = run(cfg, params, toks, LENGTHS)
    monkeypatch.setattr(ta, "prefill_attention", _flash_path)
    got_logits, got_kv = run(cfg, params, toks, LENGTHS)
    np.testing.assert_allclose(got_logits.numpy(), want_logits.numpy(),
                               **VALID_TOL)
    for (gk, gv), (wk, wv) in zip(got_kv, want_kv):
        for got, want in ((gk, wk), (gv, wv)):
            if backend == "dense":
                # (layers, B, S, Hkv, hd): rows below each length
                got = _valid(np.moveaxis(got.numpy(), 0, 2), LENGTHS)
                want = _valid(np.moveaxis(want.numpy(), 0, 2), LENGTHS)
            else:
                got, want = got[:, :-1].numpy(), want[:, :-1].numpy()
            np.testing.assert_allclose(got, want, **VALID_TOL)


def test_prefill_attention_on_cpu_is_the_plain_masked_path():
    """On CPU tensors `prefill_attention` is the JAX package's plain
    attention with the padding masked, and launches no kernel."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((3, 32, 4, 16), (3, 32, 2, 16), (3, 32, 2, 16)))
    lens = torch.from_numpy(LENGTHS)
    before = fops.flash_attention.launches
    got = ta.prefill_attention(TINY, q, k, v, lens)
    assert fops.flash_attention.launches == before
    want = ta.full_or_chunked_sdpa(q, ta._repeat_kv(k, 2), ta._repeat_kv(v, 2),
                                   causal=True, kv_lengths=lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _norms_a_call(cfg):
    """Norms one model call runs: norm1 and norm2 of an attention block
    (plus q_norm and k_norm with qk-norm), norm1 and the gated norm of a
    Mamba2 block, and the final norm."""
    per = {"attn": 2 + 2 * cfg.qk_norm, "shared_attn": 2 + 2 * cfg.qk_norm,
           "mamba2": 2}
    return sum(per[kind] for kind in cfg.block_pattern()) + 1


@pytest.mark.parametrize("name", ["tiny-cloud", "tiny-edge-a",
                                  "tiny-edge-c", "zamba2-4l"])
def test_every_norm_goes_through_the_wrapper(name, monkeypatch):
    """A scoring call of each stack kind (qk-norm, plain GQA, Mamba2, the
    zamba2 hybrid) reaches the RMSNorm wrapper once for every norm."""
    cfg = {**CONFIGS, **SSM_CONFIGS}[name]
    params = tt.init_params(cfg, seed=0, device="cpu")
    calls = []
    wrapped = tl.rms_ops.rmsnorm

    def spy(x, scale, eps=1e-6):
        calls.append(x.shape[-1])
        return wrapped(x, scale, eps)
    monkeypatch.setattr(tl.rms_ops, "rmsnorm", spy)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 12))
    tt.forward(cfg, params, torch.from_numpy(toks))
    assert len(calls) == _norms_a_call(cfg)
