"""The VLM family (internvl2-2b reduced, float32: 16 stub patch embeddings
before the tokens) against the JAX package on the same weights and inputs:
`forward` and dense `prefill` + `decode_step` with `prefix_embeds`, the
training loss that drops the patch positions and its gradients, the
text-only chunked paged and dense engines against the JAX engines; `predict_length`;
and the registry's ten architectures field by field.

Tolerances as in `test_torch_encdec.py`: `STACK_ATOL` (1e-5) for logits,
`test_torch_train_model.py`'s gates for the loss and gradients, the replay
tolerance for the engines' logprobs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (CONFIGS, STACK_ATOL, assert_close, assert_grads,
                           assert_same_replay, jax_config, masters,
                           params_pair)
from repro.configs import registry as jregistry
from repro.models import transformer as jt
from repro.serving.engine import InferenceEngine as JEngine
from repro.training import losses as jl
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.models import transformer as tt
from repro_torch.serving.engine import InferenceEngine

CFG = registry.get_config("internvl2-2b").reduced(dtype="float32",
                                                  remat=False)
JCFG = jax_config(CFG)
N_PREFIX = CFG.n_prefix_tokens


@pytest.fixture(scope="module")
def pair():
    return params_pair(CFG, seed=4)


def _patches(B=2, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, N_PREFIX, CFG.d_model)).astype(np.float32)


def test_forward_with_prefix_embeds_matches_jax(pair):
    jp, tp = pair
    rng = np.random.default_rng(2)
    toks = rng.integers(1, CFG.vocab_size, (2, 20)).astype(np.int32)
    pre = _patches()
    jlog, _, jh = jt.forward(JCFG, jp, jnp.asarray(toks),
                             prefix_embeds=jnp.asarray(pre),
                             return_hidden=True)
    tlog, _, th = tt.forward(CFG, tp, torch.from_numpy(toks).long(),
                             prefix_embeds=torch.from_numpy(pre),
                             return_hidden=True)
    assert tlog.shape == (2, N_PREFIX + 20, CFG.vocab_size)
    assert_close(tlog, jlog, atol=STACK_ATOL)
    assert_close(th, jh, atol=STACK_ATOL)


PLENS = [12, 37]
S_BUCKET = 64


def test_prefill_then_decode_with_prefix_match_jax_and_forward(pair):
    jp, tp = pair
    rng = np.random.default_rng(3)
    toks = np.zeros((2, S_BUCKET), np.int32)
    for b, n in enumerate(PLENS):
        toks[b, :n] = rng.integers(1, CFG.vocab_size, n)
    pre, plens = _patches(), np.asarray(PLENS, np.int32)
    jc = jt.init_cache(JCFG, 2, 128)
    tc = tt.init_cache(CFG, 2, 128, device="cpu")
    jlog, jc = jt.prefill(JCFG, jp, jnp.asarray(toks), jc,
                          prefix_embeds=jnp.asarray(pre),
                          prompt_lengths=jnp.asarray(plens))
    tlog, tc = tt.prefill(CFG, tp, torch.from_numpy(toks).long(), tc,
                          prompt_lengths=plens,
                          prefix_embeds=torch.from_numpy(pre))
    np.testing.assert_array_equal(tc["lengths"].numpy(), plens + N_PREFIX)
    assert_close(tlog, jlog, atol=STACK_ATOL)
    gen = [[], []]
    for _ in range(6):
        nxt = np.asarray(jlog).argmax(-1).astype(np.int32)
        for b in range(2):
            gen[b].append(int(nxt[b]))
        jlog, jc = jt.decode_step(JCFG, jp, jnp.asarray(nxt[:, None]), jc)
        tlog, tc = tt.decode_step(CFG, tp,
                                  torch.from_numpy(nxt[:, None]).long(), tc)
        assert_close(tlog, jlog, atol=STACK_ATOL)
    for b in range(2):
        seq = list(toks[b, :PLENS[b]]) + gen[b]
        flog, _ = tt.forward(CFG, tp, torch.tensor([seq]),
                             prefix_embeds=torch.from_numpy(pre[b:b + 1]))
        assert_close(tlog[b], flog[0, -1], atol=STACK_ATOL)


def test_prefill_without_lengths_covers_prefix_and_tokens(pair):
    jp, tp = pair
    toks = np.arange(1, 21, dtype=np.int32)[None].repeat(2, 0)
    pre = _patches(seed=5)
    jlog, jc = jt.prefill(JCFG, jp, jnp.asarray(toks),
                          jt.init_cache(JCFG, 2, 64),
                          prefix_embeds=jnp.asarray(pre))
    tlog, tc = tt.prefill(CFG, tp, torch.from_numpy(toks).long(),
                          tt.init_cache(CFG, 2, 64, device="cpu"),
                          prefix_embeds=torch.from_numpy(pre))
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    assert_close(tlog, jlog, atol=STACK_ATOL)


def test_lm_loss_drops_the_patch_positions_and_grads_match_jax(pair):
    jp, _ = pair
    rng = np.random.default_rng(6)
    toks = rng.integers(1, CFG.vocab_size, (2, 24)).astype(np.int32)
    tgts = rng.integers(1, CFG.vocab_size, (2, 24)).astype(np.int32)
    pre = _patches(seed=7)

    def loss_fn(p):     # JAX make_train_step's loss
        logits, aux = jt.forward(JCFG, p, jnp.asarray(toks),
                                 prefix_embeds=jnp.asarray(pre))
        return jl.lm_loss(JCFG, logits, jnp.asarray(tgts), aux,
                          prefix_len=N_PREFIX)
    (jloss, jm), jg = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    loss, metrics, grads = steps.value_and_grad(
        CFG, masters(CFG, jp), {"tokens": torch.from_numpy(toks).long(),
                                 "targets": torch.from_numpy(tgts).long(),
                                 "prefix_embeds": torch.from_numpy(pre)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert float(metrics["tokens"]) == float(jm["tokens"]) == 2 * 24
    assert_grads(grads, masters(CFG, jg), 2e-5)


@pytest.mark.parametrize("backend,chunk", [("paged", 16), ("dense", 0)],
                         ids=["chunked_paged", "dense"])
def test_text_only_engines_match_jax(pair, backend, chunk):
    """Served text-only, as the JAX engine serves it, on both backends;
    prompts of a bucket's length (32, 64), chunks of 16 on the paged one."""
    cfg = CFG.with_(prefill_chunk=chunk)
    jp, tp = pair
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (32, 64, 32)]
    kw = dict(max_batch=2, max_len=128, page_size=16, kv_backend=backend)
    want = JEngine(jax_config(cfg), jp, **kw).generate(prompts, max_new=8)
    eng = InferenceEngine(cfg, tp, device="cpu", **kw)
    got = eng.generate(prompts, max_new=8)
    assert_same_replay(got, want)
    if backend == "paged":
        assert eng.alloc.pages_in_use == 0


def test_predict_length_matches_jax():
    cfg = CONFIGS["tiny-cloud"]
    jp, tp = params_pair(cfg, seed=1)
    h = np.random.default_rng(9).standard_normal(
        (3, 11, cfg.d_model)).astype(np.float32)
    assert_close(tt.predict_length(cfg, tp, torch.from_numpy(h)),
                 jt.predict_length(jax_config(cfg), jp, jnp.asarray(h)))


def test_registry_holds_all_ten_architectures():
    ours = registry.all_configs()
    assert sorted(ours) == sorted(jregistry.ALIASES)
    for arch, want in jregistry.all_configs().items():
        got = ours[arch]
        for f in dataclasses.fields(want):
            assert _plain(getattr(got, f.name)) == \
                _plain(getattr(want, f.name)), (arch, f.name)
        tt.check_supported(got)


def _plain(value):
    """A field's value; each package's EncoderConfig as a dict."""
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    return value
