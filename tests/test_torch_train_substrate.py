"""The port's training substrate against the JAX package's: the data
pipeline's batches, the losses, the LR schedules, AdamW on fixed gradients
(the decay set leaf by leaf, a gradient no loss reached) and checkpoints.

Tolerances: batches and masks equal array for array. Losses at rtol 1e-6
(float32 logsumexp and a mean in another order). LR at rtol 1e-6 (one
float32 cos). AdamW on the same fixed gradients at rtol 1e-5, atol 1e-7:
both run the same float32 arithmetic, so params and moments differ by a few
ulps; the first step's mhat / sqrt(nhat) is close to +-1 for every
gradient well above eps (PERF.md, trap 3), which these fixed gradients
are. Checkpoints round-trip bit for bit."""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common as tc
from repro.data import corpus as jcorpus
from repro.data import pipeline as jpipe
from repro.training import checkpoint as jckpt
from repro.training import losses as jlosses
from repro.training import optimizer as jopt
from repro_torch import convert
from repro_torch.configs.pice_cloud_edge import TINY_CLOUD, TINY_EDGE_C
from repro_torch.data import corpus as tcorpus
from repro_torch.data import pipeline as tpipe
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import losses as tlosses
from repro_torch.training import optimizer as topt
from repro_torch.training import tree as tree_lib


def _close(a, b, rtol=1e-6, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq_len,batch,seed", [(64, 4, 0), (192, 8, 3),
                                                (5000, 2, 1)])
def test_packed_dataset_batches_equal_reference(seq_len, batch, seed):
    text = tcorpus.lm_text(200, seed)
    assert text == jcorpus.lm_text(200, seed)
    mine, ref = iter(tpipe.PackedDataset(text, seq_len, batch, seed)), \
        iter(jpipe.PackedDataset(text, seq_len, batch, seed))
    for _ in range(4):
        (a, b), (c, d) = next(mine), next(ref)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
        assert a.dtype == c.dtype == np.int32


def test_seq2seq_batch_equals_reference():
    pairs = [(ex.query, ex.answer) for ex in jcorpus.corpus(12, seed=4)]
    for seq_len in (16, 64, 200):
        got = tpipe.seq2seq_batch(pairs, seq_len, np.random.default_rng(5), 6)
        want = jpipe.seq2seq_batch(pairs, seq_len,
                                   np.random.default_rng(5), 6)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.fixture
def ce_block():
    old = (tlosses.CHUNKED_CE_BLOCK, jlosses.CHUNKED_CE_BLOCK)
    yield
    tlosses.CHUNKED_CE_BLOCK, jlosses.CHUNKED_CE_BLOCK = old


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("block", [0, 8, 7])
def test_cross_entropy_matches_reference(ce_block, masked, block):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 32, 50)) * 3).astype(np.float32)
    targets = rng.integers(0, 50, (3, 32)).astype(np.int32)
    mask = ((rng.random((3, 32)) > 0.4).astype(np.float32)
            if masked else None)
    tlosses.CHUNKED_CE_BLOCK = jlosses.CHUNKED_CE_BLOCK = block
    got, n = tlosses.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(mask))
    want, wn = jlosses.cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(targets),
                                     None if mask is None
                                     else jnp.asarray(mask))
    _close(got, want)
    assert float(n) == float(wn)


def test_cross_entropy_all_masked_counts_one_token():
    logits = torch.zeros(1, 4, 8)
    loss, n = tlosses.cross_entropy(logits, torch.zeros(1, 4, dtype=torch.long),
                                    torch.zeros(1, 4))
    assert float(loss) == 0.0 and float(n) == 1.0


@pytest.mark.parametrize("prefix_len,coef", [(0, 0.0), (3, 0.01)])
def test_lm_loss_matches_reference(prefix_len, coef):
    rng = np.random.default_rng(1)
    cfg = tc.TINY.with_(router_aux_coef=coef)
    logits = rng.standard_normal((2, 20 + prefix_len, 128)).astype(np.float32)
    targets = rng.integers(0, 128, (2, 20)).astype(np.int32)
    aux = np.float32(0.7)
    got_total, got = tlosses.lm_loss(cfg, torch.from_numpy(logits),
                                     torch.from_numpy(targets),
                                     torch.tensor(aux), prefix_len=prefix_len)
    want_total, want = jlosses.lm_loss(tc.jax_config(cfg),
                                       jnp.asarray(logits),
                                       jnp.asarray(targets), jnp.asarray(aux),
                                       prefix_len=prefix_len)
    _close(got_total, want_total)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], msg=k)


# ---------------------------------------------------------------------------
# learning rate, AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 40), (20, 20)])
def test_lr_at_matches_reference(schedule, warmup, total):
    kw = dict(lr=2e-3, warmup_steps=warmup, total_steps=total,
              schedule=schedule)
    mine, ref = topt.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    for step in list(range(0, 130, 7)) + [warmup, total - 1, total]:
        _close(topt.lr_at(mine, torch.tensor(step, dtype=torch.int32)),
               jopt.lr_at(ref, jnp.asarray(step, jnp.int32)),
               msg=f"step {step}")


def _ref_rule_tree(cfg, jp):
    """The JAX package's decay rule (ndim >= 2) of each of its leaves,
    converted into the port's layout as constant arrays."""
    rule = jax.tree.map(lambda p: np.full(p.shape, float(p.ndim >= 2),
                                          np.float32), jp)
    return convert.params_from_reference(cfg, rule, device="cpu",
                                         master=True)


@pytest.mark.parametrize("name", ["tiny-cloud", "tiny-edge-a", "tiny-edge-c",
                                  "zamba2-4l", "xlstm"])
def test_decay_set_follows_reference_layout(name):
    cfg = {**tc.CONFIGS, **tc.SSM_CONFIGS, "xlstm": tc.XLSTM}[name]
    jp, tp = tc.params_pair(cfg)
    want = tree_lib.leaves_with_path(_ref_rule_tree(cfg, jp))
    got = [topt.reference_ndim(path, leaf) >= 2
           for path, leaf in tree_lib.leaves_with_path(tp)]
    assert len(want) == len(got)
    escaped = []
    for (path, w), g in zip(want, got):
        assert bool(w.flatten()[0]) == g, path
        if not g:
            escaped.append(path)
    # in the stacked layout only the final norm escapes decay (and, in a
    # hybrid, the shared block's unstacked norm scales)
    assert ("final_norm", "scale") in escaped
    assert all(p == ("final_norm", "scale") or p[0] == "shared"
               for p in escaped), escaped
    assert ("segments", 0, 0, "norm1", "scale") not in escaped


def _fixed_grads(jp, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)
                              * 0.05), jp)


@pytest.mark.parametrize("cfg", [TINY_CLOUD.with_(dtype="float32"),
                                 TINY_EDGE_C.with_(dtype="float32")],
                         ids=["tiny-cloud", "tiny-edge-c"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_reference_on_fixed_grads(cfg, clip):
    jp, _ = tc.params_pair(cfg)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=5, grad_clip=clip)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu", master=True)
    jstate, tstate = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    for step in range(3):
        jg = _fixed_grads(jp, step)
        if "length_head" in jp:
            # the loss does not reach the length head: zeros in JAX, None
            # in torch
            jg = dict(jg, length_head=jnp.zeros_like(jp["length_head"]))
        tg = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jg),
                                           device="cpu", master=True)
        if "length_head" in tg:
            tg["length_head"] = None
        jp, jstate, jm = jopt.adamw_update(jcfg, jp, jg, jstate)
        tp, tstate, tm = topt.adamw_update(tcfg, tp, tg, tstate)
        _close(tm["grad_norm"], jm["grad_norm"], rtol=1e-5)
        _close(tm["lr"], jm["lr"])
        assert int(tstate.step) == int(jstate.step) == step + 1
    for mine, ref in ((tp, jp), (tstate.mu, jstate.mu),
                      (tstate.nu, jstate.nu)):
        want = convert.params_from_reference(
            cfg, jax.tree.map(np.asarray, ref), device="cpu", master=True)
        for (path, a), b in zip(tree_lib.leaves_with_path(mine),
                                tree_lib.leaves(want)):
            _close(a.detach(), b, rtol=1e-5, atol=1e-7, msg=str(path))
    if "length_head" in jp:
        # decayed and stepped although no gradient reached it
        lh0 = tc.params_pair(cfg)[0]["length_head"]
        assert not np.allclose(np.asarray(tp["length_head"]),
                               np.asarray(lh0))


def test_global_norm_counts_none_as_zero():
    g = {"a": torch.ones(2, 2), "b": None, "c": [torch.full((3,), 2.0)]}
    assert float(topt.global_norm(g)) == pytest.approx((4 + 12) ** 0.5)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.randn(4, generator=torch.Generator().manual_seed(0)
                              ).to(torch.bfloat16),
                  {"c": torch.tensor(3, dtype=torch.int32)}]}


def test_checkpoint_round_trip_f32_bf16_int():
    tree = _tree()
    with tempfile.TemporaryDirectory() as d:
        path = tckpt.save(d, 7, tree)
        assert path.endswith("/7")
        assert tckpt.latest_step(d) == 7
        out = tckpt.restore(d, None, tree)
    for a, b in zip(tree_lib.leaves(out), tree_lib.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_layout_reads_back_in_the_jax_package():
    tree = _tree()
    jtree = {"a": jnp.zeros((2, 3)), "b": [jnp.zeros((4,), jnp.bfloat16),
                                           {"c": jnp.asarray(0, jnp.int32)}]}
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 3, tree)
        out = jckpt.restore(d, 3, jtree)
    np.testing.assert_array_equal(np.asarray(out["a"]), tree["a"].numpy())
    np.testing.assert_array_equal(np.asarray(out["b"][0], np.float32),
                                  tree["b"][0].float().numpy())
    assert int(out["b"][1]["c"]) == 3


def test_checkpoint_params_and_optimizer_state_round_trip():
    cfg = TINY_EDGE_C.with_(dtype="bfloat16")
    from repro_torch.models import transformer
    params = transformer.init_params(cfg, 3, device="cpu")
    opt = topt.init_opt_state(params)
    opt.mu["final_norm"]["scale"].fill_(0.5)
    state = {"params": params, "opt": opt}
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 1, state)
        tckpt.save(d, 12, state)
        assert tckpt.latest_step(d) == 12
        out = tckpt.restore(d, 12, state)
    assert isinstance(out["opt"], topt.OptState)
    for a, b in zip(tree_lib.leaves(out), tree_lib.leaves(state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert any(t.dtype == torch.bfloat16 for t in tree_lib.leaves(out))


def test_checkpoint_shape_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 1, {"a": torch.ones(2, 2)})
        with pytest.raises(ValueError):
            tckpt.restore(d, 1, {"a": torch.ones(3, 3)})
        with pytest.raises(ValueError):
            tckpt.restore(d, 1, {"a": torch.ones(2, 2),
                                 "b": torch.ones(1)})
        assert tckpt.latest_step(d + "/none") is None
