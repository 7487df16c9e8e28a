"""The §IV-D fine-tuning pipeline of the port against the JAX package's
`finetune/*` on the CPU (TINY_EDGE_B and TINY_CLOUD in float32): the
preference scores and labels, the SFT batches and three SFT steps, the
reward model's pair encoding, forward, Bradley-Terry loss and gradients and
five training steps, the RLAIF bucket, sequence logprob and loss with their
gradients, three RLAIF steps, and the entry point.

Tolerances. Preference scores, batches and encodings are exact. Rewards,
losses and gradients follow `test_torch_train_model.py`: the loss at rtol
1e-6 (the reward at atol 1e-5, `STACK_ATOL`: a mean-pooled stack output),
gradients leaf by leaf within 2e-5 of the leaf's scale. Trained params
within the number of steps times lr, and all but 0.1 % within 1e-4; logged
losses within rtol 1e-4 plus the log's rounding. Sampled sketches are not
compared with the JAX package's: its threefry draws are not the port's
generator's."""
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (STACK_ATOL, assert_close, assert_grads,
                           jax_config, masters)
from repro.data import corpus as jcorpus
from repro.finetune import preference as jpref
from repro.finetune import reward_model as jrm
from repro.finetune import rlaif as jrl
from repro.finetune import sft as jsft
from repro.training import train_loop as jtl
from repro_torch.configs.pice_cloud_edge import TINY_CLOUD, TINY_EDGE_B
from repro_torch.finetune import __main__ as entry
from repro_torch.finetune import preference as tpref
from repro_torch.finetune import reward_model as trm
from repro_torch.finetune import rlaif as trl
from repro_torch.finetune import sft as tsft
from repro_torch.launch import steps
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl
from repro_torch.training import tree as tree_lib

CFG = TINY_EDGE_B.with_(dtype="float32")
JCFG = jax_config(CFG)


def _triples(n=12, seed=3):
    out = []
    for ex in jcorpus.corpus(n, seed=seed):
        bad = " ".join(reversed(ex.answer.split()[:30]))
        out.append((ex.answer[:120], ex.sketch, bad))
    return out


def _assert_trained(got, want, lr, steps):
    far = total = 0
    for (path, a), b in zip(tree_lib.leaves_with_path(got),
                            tree_lib.leaves(want)):
        d = (a.detach() - b).abs()
        assert float(d.max()) <= steps * lr, path
        far += int((d > 1e-4).sum())
        total += d.numel()
    assert far <= 1e-3 * total, (far, total)


def _losses(lines):
    return [float(re.search(r"loss=([0-9.]+)", s).group(1)) for s in lines]


# ---------------------------------------------------------------------------
# preference labels
# ---------------------------------------------------------------------------

def test_sketch_score_and_label_pair_equal_jax():
    for x, good, bad in _triples():
        for r in (good, bad, ""):
            for exp in (good, bad):
                assert tpref.sketch_score(r, exp, x) == \
                    jpref.sketch_score(r, exp, x)
        for expand in (lambda x, r: r, lambda x, r: x[:40] + r):
            t = tpref.label_pair(x, good + " " + x, good, bad, expand)
            j = jpref.label_pair(x, good + " " + x, good, bad, expand)
            assert (t.x, t.r_w, t.r_l, t.score_w, t.score_l) == \
                (j.x, j.r_w, j.r_l, j.score_w, j.score_l)


# ---------------------------------------------------------------------------
# SFT
# ---------------------------------------------------------------------------

def test_sft_batches_equal_jax():
    pairs = jcorpus.sketch_sft_pairs(40, 2)
    tb, jb = tsft.sft_batches(pairs, 96, 4, 2), jsft.sft_batches(pairs, 96,
                                                                 4, 2)
    for _ in range(3):
        for a, b in zip(next(tb), next(jb)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_run_sft_three_steps_match_jax():
    js = jtl.init_train_state(JCFG, 0)
    tp = masters(CFG, js.params)
    ts = ttl.TrainState(params=tp, opt_state=topt.init_opt_state(tp))
    kw = dict(n_steps=3, seq_len=64, batch=4, n_pairs=40, lr=2e-3)
    jlog, tlog = [], []
    js = jsft.run_sft(JCFG, state=js, log_fn=jlog.append, **kw)
    ts = tsft.run_sft(CFG, state=ts, log_fn=tlog.append, **kw)
    assert ts.step == 3
    np.testing.assert_allclose(_losses(tlog), _losses(jlog), rtol=1e-4,
                               atol=1e-4)
    _assert_trained(ts.params, masters(CFG, js.params), kw["lr"], 3)


# ---------------------------------------------------------------------------
# reward model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rm_pair():
    jp = jrm.init_reward_model(JCFG, 0)
    return jp, masters(CFG, jp)


def _pairs_tokens(seq_len, n=6):
    tri = _triples(n)
    tw = np.stack([trm.encode_pair(x, w, seq_len) for x, w, _ in tri])
    tl = np.stack([trm.encode_pair(x, l, seq_len) for x, _, l in tri])
    return tw, tl


def test_encode_pair_equals_jax():
    for seq_len in (16, 64, 160):
        for x, w, l in _triples(8):
            for r in (w, l, ""):
                np.testing.assert_array_equal(trm.encode_pair(x, r, seq_len),
                                              jrm.encode_pair(x, r, seq_len))


def test_reward_fwd_and_bt_loss_with_grads_match_jax(rm_pair):
    jp, tp = rm_pair
    assert tp["reward_head"].dtype == torch.float32
    tw, tl = _pairs_tokens(64)
    assert_close(trm.reward_fwd(CFG, tp, torch.from_numpy(tw).long()),
                 jrm.reward_fwd(JCFG, jp, jnp.asarray(tw)), atol=STACK_ATOL)
    (jloss, jacc), jg = jax.value_and_grad(
        lambda p: jrm.bt_loss(JCFG, p, jnp.asarray(tw), jnp.asarray(tl)),
        has_aux=True)(jp)
    loss, acc, grads = steps.grad_of(
        lambda p: trm.bt_loss(CFG, p, torch.from_numpy(tw).long(),
                              torch.from_numpy(tl).long()), tp)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    # the same pairs ranked right (the two means round 5 / 6 apart)
    np.testing.assert_allclose(float(acc), float(jacc), rtol=1e-6)
    assert_grads(grads, masters(CFG, jg), 2e-5)
    assert not any(p.requires_grad for p in tree_lib.leaves(tp))


def test_train_reward_model_five_steps_match_jax(rm_pair, monkeypatch):
    """Both start from the JAX package's `init_reward_model(cfg, 0)`; both
    draw the same batch indices from `default_rng(0)`."""
    jp0, _ = rm_pair
    monkeypatch.setattr(trm, "init_reward_model",
                        lambda cfg, seed, device=None: masters(CFG, jp0))
    tri = [jpref.PreferenceTriple(x, w, l, 1.0, 0.0)
           for x, w, l in _triples(16)]
    kw = dict(n_steps=5, batch=4, seq_len=64, lr=1e-3)
    jlog, tlog = [], []
    jp = jrm.train_reward_model(JCFG, tri, log_fn=jlog.append, **kw)
    tp = trm.train_reward_model(CFG, [tpref.PreferenceTriple(*vars(t).values())
                                      for t in tri], log_fn=tlog.append,
                                device="cpu", **kw)
    assert len(tlog) == len(jlog) == 1
    np.testing.assert_allclose(_losses(tlog), _losses(jlog), rtol=1e-4,
                               atol=1e-4)
    _assert_trained(tp, masters(CFG, jp), kw["lr"], 5)


# ---------------------------------------------------------------------------
# RLAIF
# ---------------------------------------------------------------------------

def test_pow2_bucket_equals_jax():
    for n in range(0, 700, 7):
        for cap in (64, 512):
            assert trl._pow2_bucket(n, cap) == jrl._pow2_bucket(n, cap)


def _rl_buffer(n_p, n_g, seed):
    """The loop's right-padded buffer: a pow2 bucket capped at 512, the
    generation tail-truncated at the cap."""
    rng = np.random.default_rng(seed)
    L = trl._pow2_bucket(n_p + n_g, 512)
    n_g = min(n_g, max(L - n_p, 0))
    full = np.zeros((L,), np.int32)
    full[:n_p + n_g] = rng.integers(1, 256, n_p + n_g)
    return full, n_p, n_g


@pytest.mark.parametrize("n_p,n_g", [(40, 23), (470, 64)],
                         ids=["below_cap", "past_cap"])
def test_seq_logprob_and_rlaif_loss_with_grads_match_jax(n_p, n_g):
    cfg = TINY_CLOUD.with_(dtype="float32")
    jcfg = jax_config(cfg)
    from repro.models import transformer as jt
    jp = jt.init_params(jcfg, jax.random.PRNGKey(2))
    jsft_p = jt.init_params(jcfg, jax.random.PRNGKey(3))
    tp, tsft_p = masters(cfg, jp), masters(cfg, jsft_p)
    full, n_p, n_g = _rl_buffer(n_p, n_g, seed=n_p)
    assert (len(full) == 512) == (n_p + n_g == 512)
    jfull = jnp.asarray(full)
    tfull = torch.from_numpy(full).long()
    js, jlp, jmask = jrl._seq_logprob(jcfg, jp, jfull, n_p, n_g)
    ts, tlp, tmask = trl._seq_logprob(cfg, tp, tfull, n_p, n_g)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert_close(tlp, jlp, atol=STACK_ATOL)
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-5)
    ref = jrl._seq_logprob(jcfg, jsft_p, jfull, n_p, n_g)[1]
    tref = trl._seq_logprob(cfg, tsft_p, tfull, n_p, n_g)[1]
    gamma, adv = 0.2, 0.37

    def jloss(p):       # run_rlaif's loss_fn
        sum_lp, gen_lp, mask = jrl._seq_logprob(jcfg, p, jfull, n_p, n_g)
        n_gen = jnp.maximum(jnp.sum(mask), 1.0)
        kl = jnp.sum((gen_lp - ref) * mask) / n_gen
        return -adv * sum_lp / n_gen + gamma * kl, kl
    (jl, jkl), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tl, (tkl, _), tg = steps.grad_of(
        lambda p: trl.rlaif_loss(cfg, gamma, p, tfull, n_p, n_g, adv, tref),
        tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tkl), float(jkl), rtol=1e-4, atol=1e-6)
    assert_grads(tg, masters(cfg, jg), 2e-5)


def test_run_rlaif_three_steps():
    """Step 1's KL is exactly 0 (the policy starts as the SFT params); a
    later step's is not; the SFT params, passed as the policy too, stay
    byte-equal; one seed gives one history. On one CPU thread: PyTorch's
    multi-threaded CPU backward can sum in another order from run to run
    (measured: KLs 1e-7 apart at 4 threads after SFT)."""
    params = ttl.init_train_state(CFG, 0, device="cpu").params
    before = [t.clone() for t in tree_lib.leaves(params)]
    rm = trm.init_reward_model(CFG, 1, device="cpu")
    rcfg = trl.RLAIFConfig(n_steps=3, batch=2, max_sketch_tokens=16,
                           lr=3e-3)
    runs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for _ in range(2):
            policy, hist = trl.run_rlaif(CFG, params, params, CFG, rm, rcfg,
                                         log_fn=lambda s: None)
            runs.append(hist)
    finally:
        torch.set_num_threads(threads)
    for t, b in zip(tree_lib.leaves(params), before):
        assert torch.equal(t, b)
    hist = runs[0]
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert hist[0]["kl"] == 0.0
    assert any(h["kl"] != 0.0 for h in hist[1:])
    assert runs[0] == runs[1]
    moved = [not torch.equal(a, b) for a, b in
             zip(tree_lib.leaves(policy), before)]
    assert any(moved)


def test_entry_point_runs_the_pipeline_on_the_cpu(monkeypatch):
    # the example labels 32 corpus examples; the smoke run labels 2 of them
    corpus = entry.corpus_lib.corpus
    asked = []

    def two_examples(n, seed):
        asked.append((n, seed))
        return corpus(2, seed=seed)

    monkeypatch.setattr(entry, "corpus_lib",
                        types.SimpleNamespace(corpus=two_examples))
    logs = []
    policy, hist = entry.main(["--sft-steps", "2", "--rm-steps", "2",
                                "--rl-steps", "1", "--device", "cpu"],
                               log_fn=logs.append)
    assert asked == [(32, 9)]
    assert len(hist) == 1 and hist[0]["kl"] == 0.0
    assert any(s.startswith("labeled 2 pairs") for s in logs)
    assert logs[-1].startswith("reward: ")
    args = entry.parse_args([])
    assert (args.sft_steps, args.rm_steps, args.rl_steps) == (200, 80, 20)
