"""The port's InferenceEngine over quantized pools (int8, fp8) against the
JAX package's engine on the same weights: `generate` (chunked and
monolithic prefill) and `generate_fanout`; and an int8 pool's read traffic
(`kv_bytes_read`, scales included) against a bf16 pool's on the same
requests.

Greedy tokens are equal up to the first step where they part; they may part
only where the reference's top-2 logit margin is below MARGIN, far above
the two engines' difference there. Logprobs agree within LOGPROB_ATOL: both
engines store the same quantized pages up to float noise, but one element
that noise moves across a rounding boundary is stored a full quantization
step apart, which moves later logprobs by about 1e-3 (the largest gap
measured on these requests was under 2e-4)."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_common import PROMPTS, TINY, jax_config, params_pair
from repro.models import transformer as jt
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.serving.engine import InferenceEngine

MARGIN = 0.05
LOGPROB_ATOL = 1e-2


@pytest.fixture(scope="module")
def params():
    return params_pair(TINY)


def _pair(params, kv_dtype, chunk, **kw):
    jp, tp = params
    cfg = TINY.with_(kv_dtype=kv_dtype, prefill_chunk=chunk)
    kw.setdefault("max_batch", 3)
    kw = dict(max_len=128, page_size=16, **kw)
    return (InferenceEngine(cfg, tp, device="cpu", **kw),
            JEngine(jax_config(cfg), jp, kv_backend="paged", **kw))


def _margin(jp, tokens):
    """Top-2 logit margin of the JAX package's float model after `tokens`
    (the quantized engines differ from it by quantization error only)."""
    logits, _ = jt.forward(jax_config(TINY), jp, jnp.asarray([tokens]))
    top = np.sort(np.asarray(logits[0, -1], np.float64))[-2:]
    return float(top[1] - top[0])


def _same_greedy(params, got, want, prompts):
    jp, _ = params
    compared = 0
    for i, ((tg, lg), (tw, lw)) in enumerate(zip(got, want)):
        n = min(len(tg), len(tw))
        for t in range(n):
            if tg[t] != tw[t]:
                m = _margin(jp, list(prompts[i]) + list(tw[:t]))
                assert m < MARGIN, \
                    f"request {i}: tokens part at step {t}, margin {m:.3g}"
                n = t
                break
        assert len(tg) == len(tw) or n < min(len(tg), len(tw))
        np.testing.assert_allclose(lg[:n], lw[:n], rtol=0,
                                   atol=LOGPROB_ATOL,
                                   err_msg=f"request {i}: logprobs")
        compared += n
    assert compared >= len(got)          # some of every run was compared


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("chunk", [0, 16])
def test_generate_matches_jax(params, kv_dtype, chunk):
    eng, jeng = _pair(params, kv_dtype, chunk)
    got = eng.generate(PROMPTS, max_new=12)
    want = jeng.generate(PROMPTS, max_new=12)
    _same_greedy(params, got, want, PROMPTS)
    assert eng.alloc.pages_in_use == 0


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("chunk", [0, 16])
def test_generate_fanout_matches_jax(params, kv_dtype, chunk):
    """The shared prefix is ingested once and forked copy-on-write: each
    fork's tail page, partial at 70 tokens, is copied with its scales."""
    prefix = [(i % 100) + 1 for i in range(70)]
    suffixes = [[5, 6, 7], [9], [11] * 20, []]
    eng, jeng = _pair(params, kv_dtype, chunk, max_batch=5)
    got = eng.generate_fanout(prefix, suffixes, max_new=8)
    want = jeng.generate_fanout(prefix, suffixes, max_new=8)
    _same_greedy(params, got, want, [prefix + s for s in suffixes])
    assert eng.alloc.pages_in_use == 0


def test_int8_pool_reads_half_the_bytes_of_bf16(params):
    """Same requests, same schedule (no EOS stop): an int8 page is 1 byte
    an element plus 2 f32 scales a kv head, a bf16 page 2 bytes an
    element."""
    _, tp = params
    kw = dict(max_batch=3, max_len=128, page_size=16, device="cpu",
              eos_id=-1)
    read = {}
    for kv_dtype in ("int8", "bfloat16"):
        eng = InferenceEngine(TINY.with_(kv_dtype=kv_dtype,
                                         prefill_chunk=16), tp, **kw)
        eng.generate(PROMPTS, max_new=10)
        read[kv_dtype] = eng.kv_bytes_read
    assert read["bfloat16"] > 0
    ratio = read["int8"] / read["bfloat16"]
    hd, kv, page = TINY.resolved_head_dim, TINY.n_kv_heads, 16
    # K and V: 1 byte an element and one f32 scale a kv head each, over 2
    assert ratio == pytest.approx((2 * page * kv * hd + 2 * kv * 4)
                                  / (2 * page * kv * hd * 2))
    assert 0.45 <= ratio <= 0.55
