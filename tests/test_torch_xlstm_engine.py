"""The port's engine on the xLSTM stack (xlstm-1.3b cut to 4 layers), on
both backends, against the JAX package's engines and against the contracts
the port keeps for recurrent stacks:

- at prompts of a bucket's length (32, 64 tokens: the JAX engine pads
  nothing) the port's engines give the JAX engines' greedy tokens and
  logprobs, and `score()` the JAX engine's;
- at any prompt length (5, 37) the greedy tokens are teacher-forced
  `forward`'s argmax and the logprobs its log-softmax: the port prefills a
  recurrent stack at the prompt's own length (the JAX engine scans the
  bucket padding into the states);
- a fan-out with more forks than free slots gives the late forks the early
  forks' tokens: decode keeps a parked prefix row's states (the JAX engine
  advances them);
- a reused slot answers as a fresh one: prefill starts from the initial
  states, not from what the slot held;
- eviction replays (no host swap for a recurrent stack) and equals an
  uninterrupted run; one device->host read per decode step;
- the full-size fleet is the JAX package's, xlstm-1.3b included.

Tolerances: against the JAX engines the North star's (rtol 1e-5, atol
1e-6); within the port, against `forward` and between runs that prefill
differently, SSM_TOL (see _torch_common)."""
import numpy as np
import pytest
import torch

from _torch_common import (SSM_TOL, XLSTM, assert_same_replay, jax_config,
                           params_pair, teacher_forced)
from repro.configs import pice_cloud_edge as jfleet
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.configs import pice_cloud_edge as fleet
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as tt
from repro_torch.serving.engine import InferenceEngine


@pytest.fixture(scope="module")
def setup():
    jp, tp = params_pair(XLSTM, seed=5)
    return XLSTM, jp, tp


def _engine(cfg, tp, backend="paged", **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 128)
    kw.setdefault("page_size", 16)
    return InferenceEngine(cfg, tp, kv_backend=backend, device="cpu", **kw)


def _close(a, b, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), err_msg=msg,
                               **SSM_TOL)


def _same(got, want):
    for i, ((tg, lg), (tw, lw)) in enumerate(zip(got, want)):
        assert list(tg) == list(tw), f"request {i}: tokens diverge"
        _close(lg, lw, f"request {i}: logprobs diverge")


def _prompt(n, seed):
    return [(seed * 7 + 5 * i) % 200 + 1 for i in range(n)]


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_bucket_length_prompts_match_jax(setup, backend):
    cfg, jp, tp = setup
    prompts = [_prompt(32, 1), _prompt(64, 2), _prompt(32, 3)]
    kw = dict(max_batch=3, max_len=128, page_size=16, eos_id=-1)
    want = JEngine(jax_config(cfg), jp, kv_backend=backend,
                   **kw).generate(prompts, max_new=10)
    got = _engine(cfg, tp, backend, **kw).generate(prompts, max_new=10)
    assert_same_replay(got, want)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_any_prompt_length_matches_teacher_forced_forward(setup, backend):
    cfg, _, tp = setup
    prompts = [_prompt(5, 4), _prompt(37, 5), [9]]
    eng = _engine(cfg, tp, backend, eos_id=-1)
    assert eng.recurrent and eng.prefill_chunk == 0
    out = eng.generate(prompts, max_new=8)
    for p, (toks, lps) in zip(prompts, out):
        want_toks, want_lps = teacher_forced(cfg, tp, p, toks)
        assert toks == want_toks
        _close(lps, want_lps)


def test_late_forks_match_early_forks(setup):
    """Four one-token suffixes on a 3-slot engine: the last two forks are
    admitted after decode steps have run past the parked prefix row. All
    four equal an independent submission of prefix + suffix."""
    cfg, _, tp = setup
    prefix = _prompt(32, 6)
    eng = _engine(cfg, tp, eos_id=-1)
    fan = eng.generate_fanout(prefix, [[7]] * 4, max_new=8)
    assert all(f == fan[0] for f in fan), [f[0] for f in fan]
    indep = _engine(cfg, tp, eos_id=-1).generate([prefix + [7]], max_new=8)
    _same(fan[:1], indep)
    assert eng.alloc.pages_in_use == 0


def test_fanout_with_suffixes_equals_independent_submissions(setup):
    cfg, _, tp = setup
    prefix = _prompt(20, 7)
    suffixes = [[4, 5], [6] * 9, [], [8]]
    fan = _engine(cfg, tp, max_batch=5, eos_id=-1).generate_fanout(
        prefix, suffixes, max_new=6)
    indep = _engine(cfg, tp, max_batch=5, eos_id=-1).generate(
        [prefix + s for s in suffixes], max_new=6)
    _same(fan, indep)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_reused_slot_answers_as_a_fresh_one(setup, backend):
    """One slot serves two requests in turn: the second request's answer
    is bitwise a fresh engine's."""
    cfg, _, tp = setup
    first, second = _prompt(23, 8), _prompt(11, 9)
    eng = _engine(cfg, tp, backend, max_batch=1, eos_id=-1)
    eng.generate([first], max_new=6)
    reused = eng.generate([second], max_new=6)
    fresh = _engine(cfg, tp, backend, max_batch=1, eos_id=-1).generate(
        [second], max_new=6)
    assert reused == fresh


@pytest.mark.parametrize("fanout", [False, True])
def test_eviction_replay_equals_uninterrupted(setup, fanout):
    """A small pool evicts; a victim resumes by replay (a recurrent stack
    has no host swap)."""
    cfg, _, tp = setup
    kw = dict(max_len=64, page_size=8, eos_id=-1)
    if fanout:
        prefix, suffixes = _prompt(5, 10), [[70, 71], [72], [73, 74]]
        ref = _engine(cfg, tp, max_batch=4, **kw).generate_fanout(
            prefix, suffixes, max_new=24)
        small = _engine(cfg, tp, max_batch=4, n_pages=7, **kw)
        out = small.generate_fanout(prefix, suffixes, max_new=24)
    else:
        prompts = [_prompt(4, 11), _prompt(2, 12), _prompt(3, 13)]
        ref = _engine(cfg, tp, **kw).generate(prompts, max_new=24)
        small = _engine(cfg, tp, n_pages=6, **kw)
        out = small.generate(prompts, max_new=24)
    assert not small.host_swap
    assert small.evictions > 0 and small.swap_outs == 0
    _same(out, ref)
    assert small.alloc.pages_in_use == 0


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_one_readback_per_decode_step(setup, backend, monkeypatch):
    cfg, _, tp = setup
    eng = _engine(cfg, tp, backend, eos_id=-1)
    eng.add_request(0, [1, 2, 3], max_new=6)
    eng.add_request(1, [4, 5], max_new=6)
    reads = []
    real_cpu = torch.Tensor.cpu

    def counted(t, *a, **kw):
        reads.append(tuple(t.shape))
        return real_cpu(t, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    n0 = len(eng.slots[0].tokens)
    assert eng.step() and reads == []
    for k in range(1, 4):
        assert eng.step()
        assert reads == [(2, eng.max_batch)] * k
        assert len(eng.slots[0].tokens) == n0 + k


def test_no_attention_pages(setup):
    cfg, _, tp = setup
    eng = _engine(cfg, tp)
    assert eng._page_kv_bytes == 0
    assert tt.attention_segments(cfg, eng.cache) == []
    assert len(tt.state_segments(cfg, eng.cache)) == 4


def test_score_matches_jax(setup):
    cfg, jp, tp = setup
    toks = _prompt(45, 14)
    want = JEngine(jax_config(cfg), jp, kv_backend="dense", max_batch=2,
                   max_len=128).score(toks)
    got = _engine(cfg, tp, "dense", max_batch=2).score(toks)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_fleet_is_the_reference_fleet():
    """edge_configs() names the JAX package's three edge models in its
    order, each config field for field the JAX package's."""
    want = jfleet.edge_configs()
    got = fleet.edge_configs()
    assert list(got) == list(want) == ["qwen2-1.5b", "xlstm-1.3b",
                                       "zamba2-2.7b"]
    for name, cfg in got.items():
        assert jax_config(cfg) == want[name], name
    assert get_config("xlstm-1.3b") is got["xlstm-1.3b"]
