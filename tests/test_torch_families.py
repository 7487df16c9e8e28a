"""The port's registry against the JAX package's, and the dense families
that need no new module: granite-3-8b and minitron-8b (GQA decoders,
RMSNorm, SwiGLU) reduced, float32, through the chunked paged engine against
the JAX engine; the sampler at their full vocabularies (49,155, odd, and
256,000) against the JAX sampler on the same logits and Gumbel noise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (PROMPTS, assert_close, assert_same_replay,
                           jax_config, params_pair)
from repro.configs import registry as jregistry
from repro.serving import sampler as js
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.configs import registry
from repro_torch.models import transformer as tt
from repro_torch.serving import sampler as ts
from repro_torch.serving.engine import InferenceEngine

PORTED = ("qwen3-8b", "qwen2-1.5b", "xlstm-1.3b", "zamba2-2.7b",
          "granite-3-8b", "minitron-8b", "qwen3-moe-30b-a3b", "mixtral-8x7b",
          "whisper-tiny", "internvl2-2b")


def test_registry_holds_the_eight_ported_architectures():
    """(Named for the eight it held before the encoder-decoder and VLM
    slice.) The registry holds all ten of the JAX package's architectures,
    field by field equal; an unknown name raises KeyError."""
    assert sorted(registry.ALIASES) == sorted(PORTED)
    assert sorted(PORTED) == sorted(jregistry.ALIASES)
    ours = registry.all_configs()
    for arch in PORTED:
        want = jregistry.get_config(arch)
        got = ours[arch]
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if dataclasses.is_dataclass(b):     # each package's EncoderConfig
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (arch, f.name)
        tt.check_supported(got)
    with pytest.raises(KeyError):
        registry.get_config("whisper-small")


@pytest.mark.parametrize("arch", ["granite-3-8b", "minitron-8b"])
def test_chunked_paged_engine_matches_jax(arch):
    cfg = registry.get_config(arch).reduced(dtype="float32", remat=False,
                                            prefill_chunk=16)
    jp, tp = params_pair(cfg, seed=6)
    kw = dict(max_batch=3, max_len=128, page_size=16, kv_backend="paged")
    want = JEngine(jax_config(cfg), jp, **kw).generate(PROMPTS, max_new=10)
    eng = InferenceEngine(cfg, tp, device="cpu", **kw)
    got = eng.generate(PROMPTS, max_new=10)
    assert_same_replay(got, want)
    assert eng.alloc.pages_in_use == 0


@pytest.mark.parametrize("arch", ["granite-3-8b", "minitron-8b"])
@pytest.mark.parametrize("sampler", [ts.SamplerConfig(),
                                     ts.SamplerConfig(temperature=0.8,
                                                      top_k=50, top_p=0.9)],
                         ids=["greedy", "top_k_top_p"])
def test_sampler_at_the_full_vocabulary(arch, sampler):
    V = registry.get_config(arch).vocab_size
    rng = np.random.default_rng(V)
    logits = (rng.standard_normal((4, V)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(1)
    jcfg = js.SamplerConfig(sampler.temperature, sampler.top_k,
                            sampler.top_p)
    want = js.sample(jnp.asarray(logits), key, jcfg)
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = ts.sample(torch.from_numpy(logits), sampler,
                    noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert_close(ts.token_logprob(torch.from_numpy(logits), got),
                 js.token_logprob(jnp.asarray(logits), want))
