"""The MoE stacks of the port against the JAX package's, in float32 on the
CPU at the JAX package's `init_params(cfg, PRNGKey(...))` weights:
qwen3-moe-30b-a3b.reduced() (4 experts, top-2, qk-norm), a top-8 variant
(16 experts, k = 8) and mixtral-8x7b.reduced() (4 experts, top-2, a
sliding window of 128), each at the configs' own capacity factor 1.25
(assignments drop) and at 8.0 (none drops).

- `forward` (logits and the aux loss), dense `prefill` + `decode_step`,
  and the paged entry points (`prefill_paged`, `prefill_chunk_paged`,
  `prefill_ragged_paged`, `decode_step_paged`) at the North star's
  tolerance; the paged cache refuses mixtral's window, as the JAX
  package's does.
- The dense, monolithic paged and chunked paged engines against the JAX
  engines: greedy tokens equal, logprobs within the North star's
  tolerance; `score()`; `warmup()`'s count.
- The port's own invariants at 8.0: dense == paged, fan-out ==
  independent submissions, warmed == cold, swap resume == uninterrupted.
- Three AdamW steps at the JAX launcher's schedule against
  `repro.launch.steps.make_train_step`, the aux term in the loss.

Capacity counts every token of a call (ROADMAP §3), so at 1.25 which
tokens drop depends on the call's other rows. In a batched ragged call a
row's pad queries precede the next row's tokens: they route, and at 1.25
they can take an expert's last slots from the next row. Their attention
output is unspecified in the JAX package, whose plain path lets them read
the pool past the row's length; the port's kernels write zeros there.
So at 1.25 the ragged entry point is compared on full rows, and the
chunked engine at one slot; at 8.0 both on mixed lengths and three slots.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (B, N_PAGES, P, PAGE, PROMPTS, STACK_ATOL,
                           assert_close, assert_same_pools,
                           assert_same_replay, jax_config, paged_caches,
                           params_pair)
from repro.data import corpus as jcorpus
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.models import transformer as jt
from repro.serving.engine import InferenceEngine as JEngine
from repro.training import optimizer as jopt
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.serving.engine import InferenceEngine
from repro_torch.training import optimizer as topt
from repro_torch.training import tree as tree_lib

F32 = dict(dtype="float32", remat=False)
QWEN = get_config("qwen3-moe-30b-a3b").reduced(**F32)
BASES = {
    "qwen3-moe": QWEN,
    "qwen3-moe-top8": QWEN.with_(n_experts=16, experts_per_token=8),
    "mixtral": get_config("mixtral-8x7b").reduced(**F32),
}
FACTORS = (1.25, 8.0)
ENGINE = dict(max_batch=3, max_len=128, page_size=16)


@pytest.fixture(scope="module")
def weights():
    """name -> (JAX params, port params), drawn once (the capacity factor
    changes no weight)."""
    return {name: params_pair(cfg, seed=2) for name, cfg in BASES.items()}


def _cfg(name, cf):
    return BASES[name].with_(capacity_factor=cf)


def _paged(name):
    return not BASES[name].sliding_window


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("name", list(BASES))
def test_forward_logits_and_aux(weights, name, cf, monkeypatch):
    """Also counts the dropped assignments: some at 1.25, none at 8.0."""
    cfg = _cfg(name, cf)
    jp, tp = weights[name]
    dropped = []
    dispatch = tmoe.dispatch

    def counted(*args):
        plan = dispatch(*args)
        dropped.append(int((~plan["keep"]).sum()))
        return plan
    monkeypatch.setattr(tmoe, "dispatch", counted)
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 24))
    jl, ja = jt.forward(jax_config(cfg), jp, jnp.asarray(toks))
    tl, ta = tt.forward(cfg, tp, torch.from_numpy(toks))
    assert_close(tl, jl, atol=STACK_ATOL)
    assert_close(ta, ja)
    assert float(ta) > 0
    assert len(dropped) == cfg.n_layers
    assert (sum(dropped) > 0) == (cf < 8.0), dropped


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("name", list(BASES))
def test_dense_prefill_and_decode(weights, name, cf):
    """Two right-padded prompts (12 and 7 tokens in a 12-wide buffer), then
    four decode steps with the second row inactive on the last two."""
    cfg = _cfg(name, cf)
    jc = jax_config(cfg)
    jp, tp = weights[name]
    toks = np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 12))
    L = np.array([12, 7], np.int32)
    jcache = jt.init_cache(jc, 2, 64)
    tcache = tt.init_cache(cfg, 2, 64, device="cpu")
    jl, jcache = jt.prefill(jc, jp, jnp.asarray(toks), jcache,
                            prompt_lengths=jnp.asarray(L))
    tl, tcache = tt.prefill(cfg, tp, torch.from_numpy(toks), tcache,
                            prompt_lengths=L)
    assert_close(tl, jl, atol=STACK_ATOL)
    for step in range(4):
        new = np.array([[3 + step], [40 + step]])
        active = np.array([True, step < 2])
        jl, jcache = jt.decode_step(jc, jp, jnp.asarray(new), jcache,
                                    active=jnp.asarray(active))
        tl, tcache = tt.decode_step(cfg, tp, torch.from_numpy(new), tcache,
                                    active=torch.from_numpy(active))
        assert_close(tl[active], np.asarray(jl)[active], atol=STACK_ATOL,
                     err_msg=f"decode step {step}")
    np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                  np.asarray(jcache["lengths"]))


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("name", ["qwen3-moe", "qwen3-moe-top8"])
def test_paged_entry_points(weights, name, cf):
    cfg = _cfg(name, cf)
    jc = jax_config(cfg)
    jp, tp = weights[name]
    rng = np.random.default_rng(3)
    # one monolithic prompt into slot 1 (pages 2 and 7 cover 13 tokens)
    tcache, jcache = paged_caches(cfg, 0)
    toks = rng.integers(0, cfg.vocab_size, (1, 16))
    tl, tcache = tt.prefill_paged(cfg, tp, torch.from_numpy(toks), tcache, 1,
                                  13)
    jl, jcache = jt.prefill_paged(jc, jp, jnp.asarray(toks), jcache,
                                  jnp.asarray(1), jnp.asarray(13))
    assert_close(tl, jl, atol=STACK_ATOL)
    assert_same_pools(tcache, jcache)
    # one chunk of 9 valid tokens at offset 11 of slot 0
    tcache, jcache = paged_caches(cfg, 1)
    toks = rng.integers(0, cfg.vocab_size, (1, 16))
    tl, tcache = tt.prefill_chunk_paged(cfg, tp, torch.from_numpy(toks),
                                        tcache, 0, 11, 9, live_pages=4)
    jl, jcache = jt.prefill_chunk_paged(jc, jp, jnp.asarray(toks), jcache, 0,
                                        11, 9, live_pages=4)
    assert_close(tl, jl, atol=STACK_ATOL)
    assert_same_pools(tcache, jcache)
    # batched ragged chunks, the last row a padding row; mixed lengths only
    # where nothing drops (see the module's docstring)
    tcache, jcache = paged_caches(cfg, 2)
    toks = rng.integers(0, cfg.vocab_size, (4, 8))
    slots = np.array([0, 2, 1, B], np.int32)
    offs = np.array([11, 17, 0, 0], np.int32)
    lens = (np.array([5, 3, 8, 0], np.int32) if cf > 1.25
            else np.array([8, 8, 8, 0], np.int32))
    tl, tcache = tt.prefill_ragged_paged(cfg, tp, torch.from_numpy(toks),
                                         tcache, slots, offs, lens,
                                         live_pages=4)
    jl, jcache = jt.prefill_ragged_paged(jc, jp, jnp.asarray(toks), jcache,
                                         slots, offs, lens, live_pages=4)
    assert_close(tl[:3], np.asarray(jl)[:3], atol=STACK_ATOL)
    assert_same_pools(tcache, jcache)
    # decode with an inactive row
    tcache, jcache = paged_caches(cfg, 4)
    toks = np.array([[3], [9], [27]])
    active = np.array([True, False, True])
    tl, tcache = tt.decode_step_paged(cfg, tp, torch.from_numpy(toks), tcache,
                                      active=torch.from_numpy(active),
                                      live_pages=4)
    jl, jcache = jt.decode_step_paged(jc, jp, jnp.asarray(toks), jcache,
                                      active=jnp.asarray(active),
                                      live_pages=4)
    assert_close(tl[active], np.asarray(jl)[active], atol=STACK_ATOL)
    assert_same_pools(tcache, jcache)


def test_paged_cache_refuses_a_window():
    with pytest.raises(NotImplementedError):
        tt.init_paged_cache(BASES["mixtral"], B, N_PAGES, PAGE, P,
                            device="cpu")
    with pytest.raises(NotImplementedError):
        InferenceEngine(BASES["mixtral"], {}, device="cpu", **ENGINE)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

# (backend, prefill_chunk, max_batch at 1.25): a chunked engine's ragged
# calls hold several slots' rows, whose pad queries route (module docstring)
BACKENDS = {"dense": ("dense", 0, 3), "monolithic": ("paged", 0, 3),
            "chunked": ("paged", 16, 1)}
CASES = [(name, backend) for name in BASES for backend in BACKENDS
         if _paged(name) or backend == "dense"]


def _engines(weights, name, backend, cf, **kw):
    kv, chunk, tight = BACKENDS[backend]
    cfg = _cfg(name, cf).with_(prefill_chunk=chunk)
    jp, tp = weights[name]
    kw = {**ENGINE, "max_batch": ENGINE["max_batch"] if cf > 1.25 else tight,
          **kw}
    return (JEngine(jax_config(cfg), jp, kv_backend=kv, **kw),
            InferenceEngine(cfg, tp, kv_backend=kv, device="cpu", **kw))


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("name,backend", CASES)
def test_engine_matches_jax(weights, name, backend, cf):
    jeng, eng = _engines(weights, name, backend, cf)
    want = jeng.generate(PROMPTS[:4], max_new=8)
    got = eng.generate(PROMPTS[:4], max_new=8)
    assert_same_replay(got, want)


@pytest.mark.parametrize("name", list(BASES))
def test_score_and_warmup_count_match_jax(weights, name):
    backend = "chunked" if _paged(name) else "dense"
    jeng, eng = _engines(weights, name, backend, 1.25)
    seq = PROMPTS[0] + PROMPTS[2]
    (jm, jg), (tm, tg) = jeng.score(seq), eng.score(seq)
    assert_close(tg, jg)
    args = dict(prompt_lens=(5, 40), ingest_rows=(1,))
    assert eng.warmup(**args) == jeng.warmup(**args)


@pytest.mark.parametrize("name", ["qwen3-moe", "qwen3-moe-top8"])
def test_dense_equals_paged(weights, name):
    dense = _engines(weights, name, "dense", 8.0)[1]
    paged = _engines(weights, name, "chunked", 8.0)[1]
    assert_same_replay(paged.generate(PROMPTS, max_new=8),
                       dense.generate(PROMPTS, max_new=8))


@pytest.mark.parametrize("name", ["qwen3-moe", "qwen3-moe-top8"])
def test_fanout_equals_independent_submissions(weights, name):
    prefix = [(i % 90) + 3 for i in range(40)]
    suffixes = [[4, 5], [6] * 17, [7]]
    fan = _engines(weights, name, "chunked", 8.0, max_batch=4)[1]
    indep = _engines(weights, name, "chunked", 8.0, max_batch=4)[1]
    assert_same_replay(fan.generate_fanout(prefix, suffixes, max_new=8),
                       indep.generate([prefix + s for s in suffixes],
                                      max_new=8))
    assert fan.alloc.pages_in_use == 0


@pytest.mark.parametrize("name,backend", CASES)
def test_warmed_equals_cold(weights, name, backend):
    cold = _engines(weights, name, backend, 8.0)[1]
    warm = _engines(weights, name, backend, 8.0)[1]
    assert warm.warmup(prompt_lens=(5, 40), ingest_rows=(1, 3)) > 0
    assert_same_replay(warm.generate(PROMPTS, max_new=8),
                       cold.generate(PROMPTS, max_new=8))


@pytest.mark.parametrize("name", ["qwen3-moe", "qwen3-moe-top8"])
def test_swap_resume_equals_uninterrupted(weights, name):
    prompts = [[65, 66, 67, 68], [70, 71], [80, 81, 82]]
    kw = dict(max_len=64, page_size=8)
    roomy = _engines(weights, name, "chunked", 8.0, **kw)[1]
    tight = _engines(weights, name, "chunked", 8.0, n_pages=6, **kw)[1]
    want = roomy.generate(prompts, max_new=24)
    got = tight.generate(prompts, max_new=24)
    assert tight.swap_outs > 0 and tight.swap_ins == tight.swap_outs
    assert_same_replay(got, want)
    assert tight.alloc.pages_in_use == 0 and not tight.alloc.hosted


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3-moe", "mixtral"])
def test_three_train_steps_match_jax(name):
    """Three steps from the same float32 masters and batches at the JAX
    launcher's schedule (lr 1e-3, 20 warmup steps): the losses and aux
    terms within rtol 1e-4, every param within 3 lr and all but 0.1 %
    within 1e-4 (tests/test_torch_train_model.py)."""
    cfg = BASES[name]
    jc = jax_config(cfg)
    opt = dict(lr=1e-3, warmup_steps=20, total_steps=3)
    jp = jt.init_params(jc, jax.random.PRNGKey(0))
    jstate = jopt.init_opt_state(jp)
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu", master=True)
    tstate = topt.init_opt_state(tp)
    jstep = jsteps.make_train_step(jc, jopt.AdamWConfig(**opt))
    tstep = tsteps.make_train_step(cfg, topt.AdamWConfig(**opt))
    text = jcorpus.lm_text(100, 0)
    jb = iter(jpipe.PackedDataset(text, 32, 2, 0))
    tb = iter(tpipe.PackedDataset(text, 32, 2, 0))
    for _ in range(3):
        (jtok, jtgt), (ttok, ttgt) = next(jb), next(tb)
        jbatch = {"tokens": jnp.asarray(jtok), "targets": jnp.asarray(jtgt)}
        tbatch = {"tokens": torch.from_numpy(ttok).long(),
                  "targets": torch.from_numpy(ttgt).long()}
        jp, jstate, jm = jstep(jp, jstate, jbatch)
        tp, tstate, tm = tstep(tp, tstate, tbatch)
        for k in ("loss", "aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
        assert float(tm["aux"]) > 0
    want = tree_lib.leaves(convert.params_from_reference(
        cfg, jax.tree.map(np.asarray, jp), device="cpu", master=True))
    far = total = 0
    for (path, a), b in zip(tree_lib.leaves_with_path(tp), want):
        d = (a.detach() - b).abs()
        assert float(d.max()) <= 3 * opt["lr"], path
        far += int((d > 1e-4).sum())
        total += d.numel()
    assert far <= 1e-3 * total, (far, total)


def test_moe_leaves_decay_as_in_the_reference():
    """The router (D, E) and the expert tensors (E, D, F) are 3-D and 4-D in
    the JAX package's stacked layout, so AdamW decays them; the norms'
    scales too (2-D there), the final norm's not."""
    cfg = BASES["qwen3-moe"]
    jp = jt.init_params(jax_config(cfg), jax.random.PRNGKey(0))
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu", master=True)
    flat = dict((path, leaf) for path, leaf in
                tree_lib.leaves_with_path(tp))
    moe_paths = [p for p in flat if "moe" in p]
    assert {p[-1] for p in moe_paths} == {"router", "w_gate", "w_up",
                                          "w_down"}
    jleaves = jp["segments"][0]["moe"]
    for path in moe_paths:
        want = jleaves[path[-1]].ndim
        assert topt.reference_ndim(path, flat[path]) == want, path
        assert want >= 3
    assert topt.reference_ndim(("final_norm", "scale"),
                               flat[("final_norm", "scale")]) == 1
