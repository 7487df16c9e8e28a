"""serving/sampler.py of the port against the JAX package's: the same fixed
logits and the same Gumbel noise give the same tokens (jax.random.categorical
samples argmax(logits + gumbel)), including the top-k clamp and rank-based
top-p under ties; token_logprob matches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import assert_close
from repro.serving import sampler as js
from repro_torch.serving import sampler as ts

RNG = np.random.default_rng(0)
LOGITS = RNG.standard_normal((6, 50)).astype(np.float32) * 3
# many-way ties at the top: a value-based nucleus would keep all of them
TIED = np.zeros((4, 40), np.float32)
TIED[:, :12] = 2.0
TIED[:, 12:20] = 1.0

CASES = [
    ("greedy", ts.SamplerConfig(), LOGITS),
    ("temperature", ts.SamplerConfig(temperature=0.7), LOGITS),
    ("top_k", ts.SamplerConfig(temperature=0.9, top_k=5), LOGITS),
    ("top_k_clamped", ts.SamplerConfig(temperature=0.9, top_k=500), LOGITS),
    ("top_p", ts.SamplerConfig(temperature=1.0, top_p=0.6), LOGITS),
    ("top_p_ties", ts.SamplerConfig(temperature=1.0, top_p=0.3), TIED),
    ("top_k_top_p", ts.SamplerConfig(temperature=0.8, top_k=10, top_p=0.9),
     LOGITS),
]


@pytest.mark.parametrize("name,cfg,logits", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_noise_same_tokens(name, cfg, logits, seed):
    key = jax.random.PRNGKey(seed)
    jcfg = js.SamplerConfig(cfg.temperature, cfg.top_k, cfg.top_p)
    want = js.sample(jnp.asarray(logits), key, jcfg)
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = ts.sample(torch.from_numpy(logits), cfg,
                    noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_p_ties_keep_exactly_the_nucleus():
    """With 12 tied top logits at mass 0.3, the rank-based nucleus keeps the
    first ceil(0.3 * mass) ranks only: every draw lands in the tied block's
    first ranks (stable order), never beyond them."""
    cfg = ts.SamplerConfig(temperature=1.0, top_p=0.3)
    gen = torch.Generator().manual_seed(0)
    probs = torch.softmax(torch.from_numpy(TIED[0]), -1)
    k = int(torch.searchsorted(torch.cumsum(probs, -1), 0.3)) + 1
    draws = torch.stack([ts.sample(torch.from_numpy(TIED), cfg, gen)
                         for _ in range(50)])
    kept = set(draws.flatten().tolist())
    assert len(kept) <= k and max(kept) < 12


def test_generator_draws_are_deterministic():
    cfg = ts.SamplerConfig(temperature=0.8, top_k=20)
    a = ts.sample(torch.from_numpy(LOGITS), cfg,
                  torch.Generator().manual_seed(3))
    b = ts.sample(torch.from_numpy(LOGITS), cfg,
                  torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_token_logprob():
    toks = RNG.integers(0, 50, 6)
    assert_close(ts.token_logprob(torch.from_numpy(LOGITS),
                                  torch.from_numpy(toks)),
                 js.token_logprob(jnp.asarray(LOGITS), jnp.asarray(toks)))
