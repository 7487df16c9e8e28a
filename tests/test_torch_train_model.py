"""Training the port's models against the JAX package's, in float32 on the
CPU: the loss and every gradient leaf of `steps.value_and_grad` against
`jax.value_and_grad` of the JAX package's train-step loss (transformer
`forward` + `lm_loss`) for the dense, Mamba2, xLSTM and hybrid tiny
configs; three steps of `train` and of `train(masked=True)` on both sides
from the same masters and batches; remat on == off; no host read between
log steps; the launcher's training.

Tolerances.
- Loss: rtol 1e-6 (the forward's float32 rounding; measured 3e-7); the
  perplexity exp(loss) at rtol 1e-5 (that error times the loss, about 6).
- Gradients, leaf by leaf, the JAX gradients converted with `convert`: the
  largest difference within rtol of the leaf's largest magnitude plus
  rtol x 1 % of the model's largest gradient (a floor for leaves whose
  gradient is near zero, e.g. the xLSTM input-gate bias). rtol = 2e-5 for
  attention stacks (measured 3e-6), 2e-4 for recurrent stacks, whose
  float32 activations already differ by up to 9e-5 between the packages
  (`_torch_common.SSM_TOL`; measured 5e-4 of a near-zero leaf, 1.3e-4 of
  the others).
- After 3 AdamW steps: the first steps move an element by about +-lr
  whatever its gradient's size (mhat / sqrt(nhat) is about +-1), so an
  element whose gradient is float noise can move the other way on the
  other side. Every element within 3 lr (three steps), and all but 0.1 %
  within 1e-4 (measured: at most 0.03 % past 1e-4, the worst 2.5e-3 at lr
  2e-3). The logged losses within rtol 1e-4 plus the log's rounding."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common as tc
from repro.data import corpus as jcorpus
from repro.data import pipeline as jpipe
from repro.models import transformer as jt
from repro.training import losses as jl
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch.configs.pice_cloud_edge import (TINY_CLOUD, TINY_EDGE_A,
                                                 TINY_EDGE_B, TINY_EDGE_C)
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl
from repro_torch.training import tree as tree_lib

GRAD_CONFIGS = {
    "tiny-cloud": (TINY_CLOUD, 2e-5),      # qk-norm, length head
    "tiny-edge-a": (TINY_EDGE_A, 2e-5),    # qkv bias
    "tiny-edge-b": (TINY_EDGE_B, 2e-5),    # head_dim 24
    "tiny-edge-c": (TINY_EDGE_C, 2e-4),    # Mamba2
    "xlstm": (tc.XLSTM, 2e-4),             # sLSTM, mLSTM, sLSTM, mLSTM
    "zamba2-4l": (tc.SSM_CONFIGS["zamba2-4l"], 2e-4),  # shared block x2
    "tiny-tied": (tc.TINY.with_(tie_embeddings=True), 2e-5),  # embed x2
}


def _batch(cfg, S=32, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (2, S)).astype(np.int32)
    targets = rng.integers(1, cfg.vocab_size, (2, S)).astype(np.int32)
    return tokens, targets


_masters = tc.masters
_assert_grads = tc.assert_grads


@pytest.mark.parametrize("name", list(GRAD_CONFIGS))
def test_value_and_grad_matches_jax(name):
    base, rtol = GRAD_CONFIGS[name]
    cfg = base.with_(dtype="float32")
    jcfg = tc.jax_config(cfg)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tokens, targets = _batch(cfg)

    def loss_fn(p):
        logits, aux = jt.forward(jcfg, p, jnp.asarray(tokens))
        return jl.lm_loss(jcfg, logits, jnp.asarray(targets), aux)
    (jloss, jm), jg = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    loss, metrics, grads = steps.value_and_grad(
        cfg, _masters(cfg, jp), {"tokens": torch.from_numpy(tokens).long(),
                                 "targets": torch.from_numpy(targets).long()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for k in ("nll", "tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-6)
    # exp(loss): the loss's relative error times the loss (about 6)
    np.testing.assert_allclose(float(metrics["perplexity"]),
                               float(jm["perplexity"]), rtol=1e-5)
    _assert_grads(grads, _masters(cfg, jg), rtol)
    if "length_head" in grads:
        assert grads["length_head"] is None   # the loss does not reach it
        assert not np.any(np.asarray(jg["length_head"]))


def _losses(lines):
    return [float(re.search(r"loss=([0-9.]+)", s).group(1)) for s in lines]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("base", [TINY_EDGE_A, TINY_EDGE_C, TINY_CLOUD],
                         ids=["tiny-edge-a", "tiny-edge-c", "tiny-cloud"])
def test_three_train_steps_match_jax(base, masked):
    cfg = base.with_(dtype="float32")
    jcfg = tc.jax_config(cfg)
    js = jtl.init_train_state(jcfg, 0)
    tp = _masters(cfg, js.params)
    ts = ttl.TrainState(params=tp, opt_state=topt.init_opt_state(tp))
    kw = dict(lr=2e-3, warmup_steps=2, total_steps=3)
    if masked:
        pairs = [(ex.query, ex.answer) for ex in jcorpus.corpus(12, seed=4)]

        def batches(pipe):
            rng = np.random.default_rng(0)
            while True:
                yield pipe.seq2seq_batch(pairs, 48, rng, 4)
        jb, tb = batches(jpipe), batches(tpipe)
    else:
        text = jcorpus.lm_text(100, 0)
        jb = iter(jpipe.PackedDataset(text, 48, 4, 0))
        tb = iter(tpipe.PackedDataset(text, 48, 4, 0))
    jlog, tlog = [], []
    js = jtl.train(jcfg, js, jb, jopt.AdamWConfig(**kw), 3, log_every=1,
                   log_fn=jlog.append, masked=masked)
    ts = ttl.train(cfg, ts, tb, topt.AdamWConfig(**kw), 3, log_every=1,
                   log_fn=tlog.append, masked=masked)
    assert ts.step == 3 and int(ts.opt_state.step) == 3
    np.testing.assert_allclose(_losses(tlog), _losses(jlog), rtol=1e-4,
                               atol=1e-4)
    want = tree_lib.leaves(_masters(cfg, js.params))
    far = total = 0
    for (path, a), b in zip(tree_lib.leaves_with_path(ts.params), want):
        d = (a.detach() - b).abs()
        assert float(d.max()) <= 3 * kw["lr"], path
        far += int((d > 1e-4).sum())
        total += d.numel()
    assert far <= 1e-3 * total, (far, total)


def test_remat_on_equals_off():
    cfg = TINY_CLOUD.with_(dtype="float32", remat=True)
    params = transformer.init_params(cfg, 1, device="cpu", master=True)
    tokens, targets = _batch(cfg, S=24, seed=2)
    batch = {"tokens": torch.from_numpy(tokens).long(),
             "targets": torch.from_numpy(targets).long()}
    on = steps.value_and_grad(cfg, params, batch)
    off = steps.value_and_grad(cfg.with_(remat=False), params, batch)
    assert torch.equal(on[0], off[0])
    for a, b in zip(tree_lib.leaves(on[2]), tree_lib.leaves(off[2])):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_bf16_working_params_from_f32_masters():
    cfg = TINY_EDGE_C.with_(dtype="bfloat16")
    masters = transformer.init_params(cfg, 0, device="cpu", master=True)
    working = transformer.init_params(cfg, 0, device="cpu")
    cast = transformer.cast_params(cfg, masters)
    for (path, m), c, w in zip(tree_lib.leaves_with_path(masters),
                               tree_lib.leaves(cast),
                               tree_lib.leaves(working)):
        assert m.dtype == torch.float32, path
        assert c.dtype == w.dtype and torch.equal(c, w), path
    tokens, targets = _batch(cfg, S=16)
    loss, _, grads = steps.value_and_grad(
        cfg, masters, {"tokens": torch.from_numpy(tokens).long(),
                       "targets": torch.from_numpy(targets).long()})
    assert torch.isfinite(loss)
    for g, m in zip(tree_lib.leaves(grads), tree_lib.leaves(masters)):
        assert g.dtype == torch.float32 and g.shape == m.shape


_READS = ("item", "cpu", "tolist", "numpy", "__float__", "__int__",
          "__bool__")


def test_no_host_read_between_log_steps(monkeypatch):
    cfg = TINY_EDGE_B.with_(dtype="float32")
    state = ttl.init_train_state(cfg, 0, device="cpu")
    ds = tpipe.PackedDataset(jcorpus.lm_text(50, 0), 32, 2, 0)
    reads = []
    for name in _READS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            reads.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    logs = []
    ttl.train(cfg, state, iter(ds), topt.AdamWConfig(lr=1e-3), 6,
              log_every=3, log_fn=logs.append)
    monkeypatch.undo()
    assert len(logs) == 2
    assert reads == ["tolist", "tolist"], reads


def test_launcher_trains_the_fleet_and_serves_casts():
    logs = []
    engines, _ = serve.build_engines(train_steps=2, names=("tiny-edge-b",),
                                     device="cpu", log_fn=logs.append)
    untrained, _ = serve.build_engines(train_steps=0, names=("tiny-edge-b",),
                                       device="cpu")
    assert logs[0] == "-- training tiny-edge-b for 2 steps"
    assert len([s for s in logs if s.startswith("step")]) == 2
    a = engines["tiny-edge-b"].params
    b = untrained["tiny-edge-b"].params
    moved = [not torch.equal(x, y) for x, y in
             zip(tree_lib.leaves(a), tree_lib.leaves(b))]
    assert all(moved)
    for x, y in zip(tree_lib.leaves(a), tree_lib.leaves(b)):
        assert x.dtype == y.dtype and not x.requires_grad
    assert serve.parse_args([]).train_steps == 150
