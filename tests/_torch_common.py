"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
the same configs on both sides, and JAX params converted for the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as jtransformer
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import convert
from repro_torch.configs.pice_cloud_edge import (TINY_CLOUD, TINY_EDGE_A,
                                                 TINY_EDGE_B, TINY_EDGE_C)
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as ttransformer
from repro_torch.models.config import ModelConfig
from repro_torch.training import tree as ttree

# the xdist workers share the machine's cores
torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6           # tests/test_plan_run.py::_assert_same_replay
# Activations at the end of a stack (logits, deep layers' K/V): each
# package's float32 values lie up to 4e-6 from a float64 evaluation of the
# same weights (tiny-cloud, 6 layers), so the two are compared at 1e-5
# absolute; logprobs keep the replay tolerance above.
STACK_ATOL = 1e-5

TINY = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                   max_seq_len=512, dtype="float32", remat=False)

CONFIGS = {
    "tiny": TINY,
    "tiny-cloud": TINY_CLOUD.with_(dtype="float32"),
    "tiny-edge-a": TINY_EDGE_A.with_(dtype="float32"),
    "tiny-edge-b": TINY_EDGE_B.with_(dtype="float32"),
}

# The recurrent stacks: the Mamba2 edge SLM and zamba2 cut to 4 Mamba2
# layers with the shared attention block applied twice (M M S M M S).
SSM_CONFIGS = {
    "tiny-edge-c": TINY_EDGE_C.with_(dtype="float32"),
    "zamba2-4l": get_config("zamba2-2.7b").reduced().with_(
        n_layers=4, dtype="float32", remat=False),
}
# xlstm-1.3b cut to 4 layers (sLSTM, mLSTM, sLSTM, mLSTM) and to chunks of
# 16, so that a prompt of 37 is cut differently on the two sides: the JAX
# package halves its chunk until it divides S (37 chunks of 1), the port
# runs 16 + 16 + 5.
XLSTM = get_config("xlstm-1.3b").reduced().with_(
    n_layers=4, slstm_at=(0, 2), ssm_chunk=16, dtype="float32", remat=False)
# Logits and states of a recurrent stack: one Mamba2 block's float32 output
# lies up to 1.2e-5 from a float64 evaluation on either side (TINY_EDGE_C,
# 40 tokens), and the two packages' logits differ by up to 9e-5 after four
# blocks, so they are compared at the JAX package's own tolerance for
# decode == forward over these families (tests/test_models.py:114).
SSM_TOL = dict(rtol=2e-4, atol=2e-4)

PROMPTS = [[65 + i for i in range(43)], [70, 71], [80] * 40, [90] * 17,
           [5] * 64]


def jax_config(cfg: ModelConfig) -> JModelConfig:
    """The JAX package's ModelConfig with the same field values."""
    return JModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)})


def params_pair(cfg: ModelConfig, seed: int = 0):
    """(JAX params, port params) holding the same weights."""
    jp = jtransformer.init_params(jax_config(cfg), jax.random.PRNGKey(seed))
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return jp, tp


def masters(cfg: ModelConfig, jparams):
    """A JAX params (or gradients) pytree as the port's float32 masters on
    the CPU."""
    return convert.params_from_reference(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu", master=True)


def assert_grads(got, want_tree, rtol):
    """Gradients leaf by leaf (None counts as zeros): the largest
    difference within rtol of the leaf's largest magnitude plus rtol x 1 %
    of the model's largest gradient (tests/test_torch_train_model.py)."""
    flat = ttree.leaves_with_path(got)
    want = ttree.leaves(want_tree)
    assert len(flat) == len(want)
    top = max(float(b.abs().max()) for b in want)
    for (path, a), b in zip(flat, want):
        a = torch.zeros_like(b) if a is None else a
        assert a.shape == b.shape, path
        err = float((a - b).abs().max())
        assert err <= rtol * float(b.abs().max()) + rtol * 1e-2 * top, \
            (path, err, float(b.abs().max()))


def assert_close(a, b, err_msg="", atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=atol, err_msg=err_msg)


def assert_same_replay(a, b):
    """Greedy tokens equal; logprobs within the replay tolerance."""
    for i, ((ta, la), (tb, lb)) in enumerate(zip(a, b)):
        assert list(ta) == list(tb), f"request {i}: tokens diverge"
        assert_close(la, lb, err_msg=f"request {i}: logprobs diverge")


# The paged cache state of the model-level tests: B slots over N_PAGES pages
# of PAGE rows, P block-table columns a slot.
B, N_PAGES, PAGE, P = 3, 14, 8, 6


def paged_caches(cfg, seed):
    """The same pre-filled pool state, lengths and block table on both
    sides: slot 0 holds 11 tokens, slot 1 holds 0, slot 2 holds 17 tokens
    and shares slot 0's first page (a COW fork)."""
    rng = np.random.default_rng(seed)
    tc = ttransformer.init_paged_cache(cfg, B, N_PAGES, PAGE, P, device="cpu")
    jc = jtransformer.init_paged_cache(jax_config(cfg), B, N_PAGES, PAGE, P)
    # the port's pools carry one scratch page; the JAX side takes the same
    # random pools, extra page included, as plain pages it never maps
    table = np.full((B, P), -1, np.int32)
    table[0, :3] = [4, 1, 9]
    table[1, :2] = [2, 7]
    table[2, :4] = [4, 3, 11, 12]
    lengths = np.array([11, 0, 17], np.int32)
    tc["block_table"].copy_(torch.from_numpy(table))
    tc["lengths"].copy_(torch.from_numpy(lengths))
    jc["block_table"], jc["lengths"] = jnp.asarray(table), jnp.asarray(lengths)
    for tseg, jseg in zip(tc["segments"], jc["segments"]):
        for k in ("k_pages", "v_pages"):
            a = rng.standard_normal(tuple(tseg[k].shape)).astype(np.float32)
            tseg[k].copy_(torch.from_numpy(a))
            jseg[k] = jnp.asarray(a)
    return tc, jc


def assert_same_pools(tc, jc):
    """Equal lengths and pools, apart from the port's scratch page (the
    last page of each pool, where dropped writes land)."""
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    for tseg, jseg in zip(tc["segments"], jc["segments"]):
        for k in ("k_pages", "v_pages"):
            assert_close(tseg[k][:, :-1], np.asarray(jseg[k])[:, :-1],
                         err_msg=k, atol=STACK_ATOL)


def teacher_forced(cfg, tp, prompt, toks):
    """forward's greedy tokens and logprobs along prompt + toks."""
    logits, _ = ttransformer.forward(
        cfg, tp, torch.tensor([list(prompt) + list(toks)]))
    lp = torch.log_softmax(logits[0].float(), dim=-1)
    rows = lp[len(prompt) - 1:len(prompt) - 1 + len(toks)]
    return (rows.argmax(-1).tolist(),
            rows.gather(-1, torch.tensor(toks)[:, None])[:, 0].tolist())
