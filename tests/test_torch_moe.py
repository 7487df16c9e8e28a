"""The port's MoE FFN (`repro_torch.models.moe`) against the JAX package's
`moe_fwd` on the same params and inputs: both dispatches (the one-hot
cumsum and the stable argsort), E 2-16 experts, top-k 1-8, B 1-4, S 2-16,
at capacity factors that drop most assignments (1e-6), some (1.25) and
none (8.0). Outputs and the aux loss within the North star's float32
tolerance (rtol 1e-5, atol 1e-6), the kept set equal, and the gradients of
one loss within 1e-5 of the largest magnitude of each of `jax.grad`'s.
Also: ties in the router go to the lower expert index as in
`jax.lax.top_k`, the capacity rule, the init shapes, and a repeated call
is bitwise equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip(
    "hypothesis",
    reason="property tests need hypothesis (pip install -r requirements-test.txt)")
from hypothesis import given, settings, strategies as st

from _torch_common import RTOL, ATOL, jax_config
from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig

CAPACITY_FACTORS = (1e-6, 1.25, 8.0)


def _cfg(E, K, cf=1.25, sort=False, d=32):
    return ModelConfig(name="m", family="moe", n_layers=1, d_model=d,
                       n_heads=4, n_kv_heads=4, d_ff=64, moe_d_ff=48,
                       vocab_size=64, n_experts=E, experts_per_token=K,
                       capacity_factor=cf, moe_sort_dispatch=sort,
                       dtype="float32")


def _pair(cfg, seed):
    key = jax.random.PRNGKey(seed)
    jp = jmoe.init_moe(jax_config(cfg), key)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


def _x(cfg, B, S, seed):
    return np.array(jax.random.normal(jax.random.PRNGKey(100 + seed),
                                      (B, S, cfg.d_model)), np.float32)


def _jax_keep(cfg, params, x):
    """The JAX package's kept set, step for step as its moe_fwd builds it
    (router top-k, then the cumsum positions against the capacity)."""
    T = x.shape[0] * x.shape[1]
    xf = jnp.asarray(x).reshape(T, -1)
    probs = jax.nn.softmax((xf @ params["router"]).astype(jnp.float32), -1)
    _, top_e = jax.lax.top_k(probs, cfg.experts_per_token)
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, cfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return np.asarray(pos < jmoe.moe_capacity(T, jax_config(cfg)))


def _close(a, b, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


@given(st.integers(min_value=2, max_value=16),     # experts
       st.integers(min_value=1, max_value=8),      # top-k
       st.integers(min_value=1, max_value=4),      # batch
       st.integers(min_value=2, max_value=16),     # seq
       st.sampled_from(CAPACITY_FACTORS),
       st.booleans(),                              # sort dispatch
       st.integers(min_value=0, max_value=5))      # seed
@settings(max_examples=30, deadline=None)
def test_moe_fwd_matches_jax(E, K, B, S, cf, sort, seed):
    K = min(K, E)
    cfg = _cfg(E, K, cf, sort)
    jp, tp = _pair(cfg, seed)
    x = _x(cfg, B, S, seed)
    jo, ja = jmoe.moe_fwd(jax_config(cfg), jp, jnp.asarray(x))
    to, ta = tmoe.moe_fwd(cfg, tp, torch.from_numpy(x))
    _close(to, jo, "outputs")
    _close(ta, ja, "aux")
    _, top_e, _ = tmoe.route(cfg, tp, torch.from_numpy(x).reshape(B * S, -1))
    keep = tmoe.dispatch(cfg, top_e, tmoe.moe_capacity(B * S, cfg))["keep"]
    np.testing.assert_array_equal(keep.numpy(), _jax_keep(cfg, jp, x))


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("sort", [False, True])
def test_gradients_match_jax(cf, sort):
    """d/d(params, x) of sum(out ** 2) + 0.01 * aux against jax.grad."""
    cfg = _cfg(8, 2, cf, sort)
    jp, tp = _pair(cfg, 3)
    x = _x(cfg, 2, 12, 3)

    def jloss(p, xx):
        o, aux = jmoe.moe_fwd(jax_config(cfg), p, xx)
        return jnp.sum(o ** 2) + 0.01 * aux
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    for v in tp.values():
        v.requires_grad_(True)
    o, aux = tmoe.moe_fwd(cfg, tp, tx)
    loss = (o ** 2).sum() + 0.01 * aux
    grads = torch.autograd.grad(loss, list(tp.values()) + [tx])
    want = [np.asarray(jg[k]) for k in tp] + [np.asarray(jgx)]
    for name, g, w in zip(list(tp) + ["x"], grads, want):
        # float32 sums of many products, taken in another order: within
        # 1e-5 of the gradient's largest magnitude
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err < 1e-5, (name, err)
    assert all(float(g.abs().sum()) > 0 for g in grads)


def test_ties_go_to_the_lower_expert():
    """Equal router probabilities: the k chosen experts are the lowest
    indices, as jax.lax.top_k picks them."""
    cfg = _cfg(8, 3, 8.0)
    jp, tp = _pair(cfg, 0)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(cfg, 1, 5, 0)
    _, top_e, _ = tmoe.route(cfg, tp, torch.from_numpy(x)[0])
    assert top_e.tolist() == [[0, 1, 2]] * 5
    _close(tmoe.moe_fwd(cfg, tp, torch.from_numpy(x))[0],
           jmoe.moe_fwd(jax_config(cfg), jp, jnp.asarray(x))[0])


@pytest.mark.parametrize("T", [1, 8, 37, 1024])
def test_capacity_rule(T):
    for E, K, cf in ((128, 8, 1.25), (8, 2, 1.25), (4, 2, 8.0), (16, 8, 1e-6)):
        cfg = _cfg(E, K, cf)
        assert tmoe.moe_capacity(T, cfg) == jmoe.moe_capacity(T,
                                                              jax_config(cfg))


def test_init_shapes_and_law():
    cfg = _cfg(6, 2)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(cfg, gen, torch.float32)
    jp = jmoe.init_moe(jax_config(cfg), jax.random.PRNGKey(0))
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(p[k].shape) == tuple(jp[k].shape), k
    # N(0, 1/fan_in) over the input axis (d for all but w_down's f)
    for k, fan in (("w_gate", 32), ("w_down", 48)):
        std = float(p[k].std()) * fan ** 0.5
        assert 0.9 < std < 1.1, (k, std)


def test_capacity_drops_and_repeat_is_bitwise():
    """At a factor near 0 the floor of 4 slots an expert keeps few
    assignments; at 8.0 none drops. A repeated call is bitwise equal (no
    atomics in the dispatch or the combine)."""
    x = torch.from_numpy(_x(_cfg(4, 2), 2, 16, 0))
    kept = {}
    for cf in (1e-6, 8.0):
        cfg = _cfg(4, 2, cf)
        _, tp = _pair(cfg, 0)
        _, top_e, _ = tmoe.route(cfg, tp, x.reshape(32, -1))
        plan = tmoe.dispatch(cfg, top_e, tmoe.moe_capacity(32, cfg))
        kept[cf] = int(plan["keep"].sum())
        a = tmoe.moe_fwd(cfg, tp, x)[0]
        b = tmoe.moe_fwd(cfg, tp, x)[0]
        assert torch.equal(a, b)
    assert kept[1e-6] == 16 and kept[8.0] == 64
