"""models/layers.py of the port against the JAX package's, on the same
inputs (numpy, from a seed), plus the port's init shapes against the JAX
init after conversion."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import CONFIGS, assert_close, jax_config, params_pair
from repro.models import layers as jl
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt

RNG = np.random.default_rng(0)


def _x(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def test_rmsnorm():
    x, s = _x(3, 5, 64), _x(64)
    assert_close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
                 jl.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 3, 4, 32)])
def test_rmsnorm_goes_through_the_wrapper(shape, monkeypatch):
    """`layers.rmsnorm` is one call of the RMSNorm wrapper (a norm row, or a
    q/k-norm head row), and still the JAX package's `layers.rmsnorm`."""
    x, s = _x(*shape), _x(shape[-1])
    calls = []
    wrapped = tl.rms_ops.rmsnorm

    def spy(*args):
        calls.append(args)
        return wrapped(*args)
    monkeypatch.setattr(tl.rms_ops, "rmsnorm", spy)
    got = tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    assert len(calls) == 1 and calls[0][2] == 1e-6
    assert_close(got, jl.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("hd", [24, 32, 128])
def test_rope(hd):
    x = _x(2, 7, 3, hd)
    pos = RNG.integers(0, 900, (2, 7))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)


def test_rope_tables_reused_equal_direct():
    x = _x(2, 4, 3, 32)
    pos = torch.from_numpy(RNG.integers(0, 100, (2, 4)))
    direct = tl.apply_rope(torch.from_numpy(x), pos, 1e4)
    tables = tl.rope_tables(pos, 32, 1e4)
    torch.testing.assert_close(
        tl.apply_rope(torch.from_numpy(x), tables=tables), direct,
        rtol=0, atol=0)


def test_swiglu_mlp_and_embeddings():
    cfg = CONFIGS["tiny-edge-a"]
    jp, tp = params_pair(cfg)
    layer_j = jax.tree.map(lambda a: a[0], jp["segments"][0])
    layer_t = tp["segments"][0][0]
    x = _x(2, 5, cfg.d_model)
    assert_close(tl.mlp(cfg, layer_t["mlp"], torch.from_numpy(x)),
                 jl.mlp(jax_config(cfg), layer_j["mlp"], jnp.asarray(x)))
    toks = RNG.integers(0, cfg.vocab_size, (2, 5))
    assert_close(tl.embed(cfg, tp["embed"], torch.from_numpy(toks)),
                 jl.embed(jax_config(cfg), jp["embed"], jnp.asarray(toks)))
    assert_close(tl.unembed(cfg, tp["embed"], torch.from_numpy(x)),
                 jl.unembed(jax_config(cfg), jp["embed"], jnp.asarray(x)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_params_matches_reference_layout(name):
    """The port's own init draws the JAX package's shapes (after
    conversion), dtypes, and init law (norm scales one, biases zero,
    dense weights of std 1/sqrt(fan_in))."""
    cfg = CONFIGS[name]
    _, converted = params_pair(cfg)
    own = tt.init_params(cfg, seed=0, device="cpu")
    flat_c = dict(_leaves(converted))
    flat_o = dict(_leaves(own))
    assert flat_c.keys() == flat_o.keys()
    for k, v in flat_o.items():
        assert v.shape == flat_c[k].shape and v.dtype == flat_c[k].dtype, k
        if k.endswith(("scale", "q_norm", "k_norm")):
            assert torch.all(v == 1), k
        elif k.split("/")[-1] in ("bq", "bk", "bv"):
            assert torch.all(v == 0), k
    wq = own["segments"][0][0]["attn"]["wq"]
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.1


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree
