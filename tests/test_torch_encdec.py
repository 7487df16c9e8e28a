"""The encoder-decoder family (whisper-tiny reduced, float32: a 2-layer
encoder over 64 stub frames of width 256, 4 query heads over 2 KV heads in
the decoder) against the JAX package on the same weights and inputs:
LayerNorm and the GELU MLP, `encode` (the JAX side also through
`flash_attention_pallas` in interpret mode), the cross-attention paths,
`forward`, dense `prefill` + `decode_step` and the step builders, one train
step's loss and gradients, three AdamW steps, and the refusals (the
engine, the paged cache, the launcher).

Tolerances: rtol 1e-5 with atol 1e-6 for one layer's function; atol 1e-5
(`STACK_ATOL`) for what comes out of a stack (the encoder's output, the
logits, the cross K/V): each package's float32 values there lie a few 1e-6
from the other's (measured up to 3.8e-6 on the cross V). Gradients and the
AdamW steps use `test_torch_train_model.py`'s attention-stack gates."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_common import (STACK_ATOL, assert_close, assert_grads,
                           jax_config, masters, params_pair)
from repro.launch import steps as jsteps
from repro.models import attention as ja
from repro.models import layers as jlayers
from repro.models import transformer as jt
from repro.training import losses as jl
from repro.training import optimizer as jopt
from repro_torch.configs.registry import get_config
from repro_torch.launch import steps
from repro_torch.launch import train as train_launcher
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.serving.engine import InferenceEngine
from repro_torch.training import optimizer as topt
from repro_torch.training import tree as tree_lib

CFG = get_config("whisper-tiny").reduced(dtype="float32", remat=False)
JCFG = jax_config(CFG)
D_ENC = CFG.encoder.d_model
N_CTX = CFG.encoder.n_ctx


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return params_pair(CFG, seed=3)


def _frames(n=N_CTX, B=2, seed=1):
    return _x(np.random.default_rng(seed), B, n, D_ENC)


def _layer0(jp, tp, key):
    """Decoder layer 0's `key` subtree on both sides."""
    return (jax.tree.map(lambda a: a[0], jp["segments"][0][key]),
            tp["segments"][0][0][key])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layernorm_and_norm_match_jax(eps):
    rng = np.random.default_rng(0)
    x = _x(rng, 3, 7, 96) * 3 + 1
    scale, bias = _x(rng, 96), _x(rng, 96)
    got = tl.layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                       torch.from_numpy(bias), eps)
    want = jlayers.layernorm(jnp.asarray(x), jnp.asarray(scale),
                             jnp.asarray(bias), eps)
    assert_close(got, want)
    cfg = CFG.with_(norm_eps=eps)
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    assert_close(tl.norm(cfg, p, torch.from_numpy(x)),
                 jlayers.norm(jax_config(cfg), {"scale": jnp.asarray(scale),
                                                "bias": jnp.asarray(bias)},
                              jnp.asarray(x)))
    # bf16 in, bf16 out; the arithmetic in float32
    xb = torch.from_numpy(x).bfloat16()
    out = tl.norm(cfg, p, xb)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tl.layernorm(xb.float(), p["scale"], p["bias"],
                                         eps).bfloat16())


def test_gelu_mlp_matches_jax_and_erf_misses(pair):
    jp, tp = pair
    jm, tm = _layer0(jp, tp, "mlp")
    assert "w_gate" not in tm and set(tm) == {"w_up", "b_up", "w_down",
                                             "b_down"}
    rng = np.random.default_rng(2)
    # random biases, so both are exercised
    for k in ("b_up", "b_down"):
        b = _x(rng, *tm[k].shape)
        tm = dict(tm, **{k: torch.from_numpy(b)})
        jm = dict(jm, **{k: jnp.asarray(b)})
    x = _x(rng, 2, 9, CFG.d_model)
    want = np.asarray(jlayers.mlp(JCFG, jm, jnp.asarray(x)))
    got = tl.mlp(CFG, tm, torch.from_numpy(x))
    assert_close(got, want)
    # the erf GELU, F.gelu's default, is a different function: it misses
    # the parity tolerance
    h = torch.from_numpy(x) @ tm["w_up"] + tm["b_up"]
    erf = F.gelu(h) @ tm["w_down"] + tm["b_down"]
    with pytest.raises(AssertionError):
        assert_close(erf, want)


def test_init_params_has_the_reference_structure(pair):
    _, tp = pair
    mine = tt.init_params(CFG, seed=0, device="cpu")
    assert tree_lib.structure(mine) == tree_lib.structure(tp)
    for (path, a), b in zip(tree_lib.leaves_with_path(mine),
                            tree_lib.leaves(tp)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert mine["dec_pos"].shape == (CFG.max_seq_len, CFG.d_model)
    assert len(mine["encoder"]["blocks"]) == CFG.encoder.n_layers
    layer = mine["segments"][0][0]
    assert "q_norm" not in layer["xattn"]
    assert layer["xattn"]["wk"].shape == (D_ENC, CFG.n_kv_heads
                                          * CFG.resolved_head_dim)
    assert set(layer["norm_x"]) == {"scale", "bias"}
    assert layer["norm1"]["bias"].dtype == torch.float32


# ---------------------------------------------------------------------------
# encoder and cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [N_CTX, 40], ids=["n_ctx", "short"])
@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
def test_encode_matches_jax(pair, n, pallas):
    """Non-causal self-attention: `flash_attention_pallas` (interpret mode)
    on the JAX side with `pallas`, the flash wrapper's plain version on the
    port's."""
    jp, tp = pair
    frames = _frames(n)
    jcfg = dataclasses.replace(JCFG, use_pallas=pallas)
    want = jt.encode(jcfg, jp["encoder"], jnp.asarray(frames))
    got = tt.encode(CFG, tp["encoder"], torch.from_numpy(frames))
    assert got.shape == (2, n, D_ENC)
    assert_close(got, want, atol=STACK_ATOL)


def test_encode_refuses_frames_outside_the_compute_dtype():
    """The JAX package would run the encoder in float32 for float32 frames
    on a bfloat16 config; the port computes in cfg.dtype only."""
    cfg = get_config("whisper-tiny").reduced()
    assert cfg.dtype == "bfloat16"
    params = tt.init_params(cfg, 0, device="cpu")
    frames = torch.from_numpy(_frames(8))
    with pytest.raises(ValueError, match="enc_frames must be"):
        tt.encode(cfg, params["encoder"], frames)
    got = tt.encode(cfg, params["encoder"], frames.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()


def test_cross_attention_fwd_and_cached_match_jax(pair):
    jp, tp = pair
    jx, tx = _layer0(jp, tp, "xattn")
    rng = np.random.default_rng(4)
    x, enc = _x(rng, 2, 5, CFG.d_model), _x(rng, 2, 33, D_ENC)
    want = ja.cross_attention_fwd(JCFG, jx, jnp.asarray(x), jnp.asarray(enc))
    got = ta.cross_attention_fwd(CFG, tx, torch.from_numpy(x),
                                 torch.from_numpy(enc))
    assert_close(got, want)
    _, ck, cv = ja._project_qkv(JCFG, jx, jnp.asarray(x),
                                kv_x=jnp.asarray(enc))
    want = ja.cross_attention_cached(JCFG, jx, jnp.asarray(x[:, :1]), ck, cv)
    got = ta.cross_attention_cached(
        CFG, tx, torch.from_numpy(x[:, :1]),
        torch.from_numpy(np.asarray(ck)), torch.from_numpy(np.asarray(cv)))
    assert_close(got, want)


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

def test_forward_matches_jax(pair):
    jp, tp = pair
    rng = np.random.default_rng(5)
    toks = rng.integers(1, CFG.vocab_size, (2, 20)).astype(np.int32)
    frames = _frames()
    jlog, jaux, jh = jt.forward(JCFG, jp, jnp.asarray(toks),
                                enc_frames=jnp.asarray(frames),
                                return_hidden=True)
    tlog, taux, th = tt.forward(CFG, tp, torch.from_numpy(toks).long(),
                                enc_frames=torch.from_numpy(frames),
                                return_hidden=True)
    assert_close(tlog, jlog, atol=STACK_ATOL)
    assert_close(th, jh, atol=STACK_ATOL)
    assert float(taux) == float(jaux) == 0.0
    with pytest.raises(ValueError, match="enc_frames"):
        tt.forward(CFG, tp, torch.from_numpy(toks).long())


PLENS = [12, 37]
S_BUCKET = 64          # 37 padded to its bucket
N_DECODE = 6


def _padded_prompts():
    rng = np.random.default_rng(6)
    toks = np.zeros((2, S_BUCKET), np.int32)
    for b, n in enumerate(PLENS):
        toks[b, :n] = rng.integers(1, CFG.vocab_size, n)
    return toks


@pytest.mark.parametrize("n_frames", [N_CTX, 40], ids=["n_ctx", "short"])
def test_prefill_then_decode_match_jax_and_forward(pair, n_frames):
    jp, tp = pair
    toks, frames = _padded_prompts(), _frames(n_frames)
    plens = np.asarray(PLENS, np.int32)
    jc = jt.init_cache(JCFG, 2, 128)
    tcache = tt.init_cache(CFG, 2, 128, device="cpu")
    jlog, jc = jt.prefill(JCFG, jp, jnp.asarray(toks), jc,
                          enc_frames=jnp.asarray(frames),
                          prompt_lengths=jnp.asarray(plens))
    tlog, tcache = tt.prefill(CFG, tp, torch.from_numpy(toks).long(),
                              tcache, prompt_lengths=plens,
                              enc_frames=torch.from_numpy(frames))
    assert_close(tlog, jlog, atol=STACK_ATOL)
    # the cross K/V: the encoder's output through each layer's wk / wv,
    # byte for byte, and the JAX package's within the stack tolerance
    enc = tt.encode(CFG, tp["encoder"], torch.from_numpy(frames))
    for j, (tseg, jseg) in enumerate(zip(tcache["segments"],
                                         jc["segments"])):
        for key in ("cross_k", "cross_v"):
            assert tseg[key].shape[2] == n_frames
            assert_close(tseg[key], jseg[key], atol=STACK_ATOL, err_msg=key)
        for i, layer in enumerate(tp["segments"][j]):
            _, ck, cv = ta._project_qkv(CFG, layer["xattn"], enc[:, :1],
                                        kv_x=enc)
            assert torch.equal(tseg["cross_k"][i], ck)
            assert torch.equal(tseg["cross_v"][i], cv)
        for key in ("k", "v"):
            assert_close(tseg[key], jseg[key], atol=STACK_ATOL, err_msg=key)
    gen = [[], []]
    for _ in range(N_DECODE):
        nxt = np.asarray(jlog).argmax(-1).astype(np.int32)
        for b in range(2):
            gen[b].append(int(nxt[b]))
        jlog, jc = jt.decode_step(JCFG, jp, jnp.asarray(nxt[:, None]), jc)
        tlog, tcache = tt.decode_step(CFG, tp,
                                      torch.from_numpy(nxt[:, None]).long(),
                                      tcache)
        assert_close(tlog, jlog, atol=STACK_ATOL)
    np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                  plens + N_DECODE)
    # the port's own teacher-forced forward over prompt + generated tokens
    for b in range(2):
        seq = list(toks[b, :PLENS[b]]) + gen[b]
        flog, _ = tt.forward(CFG, tp, torch.tensor([seq]),
                             enc_frames=torch.from_numpy(frames[b:b + 1]))
        # the last decode step's logits are those after the final token
        assert_close(tlog[b], flog[0, -1], atol=STACK_ATOL)


def test_step_builders_take_enc_frames(pair):
    jp, tp = pair
    toks, frames = _padded_prompts(), _frames()
    plens = np.asarray(PLENS, np.int32)
    jpre, jdec = jsteps.make_prefill_step(JCFG), jsteps.make_decode_step(JCFG)
    tpre, tdec = steps.make_prefill_step(CFG), steps.make_decode_step(CFG)
    jlog, jc = jpre(jp, jnp.asarray(toks), jt.init_cache(JCFG, 2, 128),
                    jnp.asarray(plens), enc_frames=jnp.asarray(frames))
    tlog, tcache = tpre(tp, torch.from_numpy(toks).long(),
                        tt.init_cache(CFG, 2, 128, device="cpu"), plens,
                        enc_frames=torch.from_numpy(frames))
    assert_close(tlog, jlog, atol=STACK_ATOL)
    nxt = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
    jlog, _ = jdec(jp, jnp.asarray(nxt), jc)
    tlog, _ = tdec(tp, torch.from_numpy(nxt).long(), tcache)
    assert_close(tlog, jlog, atol=STACK_ATOL)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(seed=7, S=24):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, CFG.vocab_size, (2, S)).astype(np.int32),
            "targets": rng.integers(1, CFG.vocab_size,
                                    (2, S)).astype(np.int32),
            "enc_frames": _frames(seed=seed)}


def _torch_batch(b):
    return {"tokens": torch.from_numpy(b["tokens"]).long(),
            "targets": torch.from_numpy(b["targets"]).long(),
            "enc_frames": torch.from_numpy(b["enc_frames"])}


def test_train_step_loss_and_gradients_match_jax(pair):
    jp, _ = pair
    b = _batch()

    def loss_fn(p):     # JAX make_train_step's loss
        logits, aux = jt.forward(JCFG, p, jnp.asarray(b["tokens"]),
                                 enc_frames=jnp.asarray(b["enc_frames"]))
        return jl.lm_loss(JCFG, logits, jnp.asarray(b["targets"]), aux)
    (jloss, _), jg = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    loss, _, grads = steps.value_and_grad(CFG, masters(CFG, jp),
                                          _torch_batch(b))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert_grads(grads, masters(CFG, jg), 2e-5)
    assert grads["encoder"]["blocks"][0]["attn"]["wq"] is not None


def test_three_adamw_steps_match_jax(pair):
    jp, _ = pair
    kw = dict(lr=2e-3, warmup_steps=2, total_steps=3)
    jstep = jax.jit(jsteps.make_train_step(JCFG, jopt.AdamWConfig(**kw)))
    tstep = steps.make_train_step(CFG, topt.AdamWConfig(**kw))
    tp = masters(CFG, jp)
    jstate, tstate = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    for i in range(3):
        b = _batch(seed=10 + i)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        tp, tstate, tm = tstep(tp, tstate, _torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
    far = total = 0
    for (path, a), w in zip(tree_lib.leaves_with_path(tp),
                            tree_lib.leaves(masters(CFG, jp))):
        d = (a.detach() - w).abs()
        assert float(d.max()) <= 3 * kw["lr"], path
        far += int((d > 1e-4).sum())
        total += d.numel()
    assert far <= 1e-3 * total, (far, total)


def test_decay_set_covers_the_encoder(pair):
    """The JAX package decays its leaves of ndim >= 2; its encoder blocks
    are stacked, so every leaf there decays, while the two final norms
    (scale and bias) escape."""
    jp, tp = pair
    rule = jax.tree.map(lambda p: np.full(p.shape, float(p.ndim >= 2),
                                          np.float32), jp)
    want = tree_lib.leaves(masters(CFG, rule))
    escaped = []
    for (path, leaf), w in zip(tree_lib.leaves_with_path(tp), want):
        got = topt.reference_ndim(path, leaf) >= 2
        assert got == bool(w.flatten()[0]), path
        if not got:
            escaped.append(path)
    assert sorted(escaped) == sorted([
        ("encoder", "final_norm", "bias"), ("encoder", "final_norm", "scale"),
        ("final_norm", "bias"), ("final_norm", "scale")])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_engine_refuses_encdec(pair, backend):
    _, tp = pair
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        InferenceEngine(CFG, tp, kv_backend=backend, max_len=64,
                        page_size=16, device="cpu")


def test_paged_cache_refuses_cross_attention():
    with pytest.raises(NotImplementedError, match="cross-attention"):
        tt.init_paged_cache(CFG, 2, 4, 8, 2, device="cpu")


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-2b"])
def test_launcher_refuses_families_that_need_stub_inputs(arch):
    with pytest.raises(ValueError, match="stub"):
        train_launcher.main(["--arch", arch, "--steps", "1",
                             "--device", "cpu"])
