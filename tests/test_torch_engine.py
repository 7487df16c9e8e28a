"""The port's InferenceEngine (paged, chunked, batched ragged ingest) against
the JAX package's engine with the same prefill_chunk and weights, and the
port's own invariants: batched ragged ingest == one row at a time, fan-out
== independent submissions, eviction-replay == uninterrupted, and cancel
leaves survivors unchanged. A dense engine refuses a quantized pool. (Host
swap and the serial scheduler: tests/test_torch_swap.py and
tests/test_torch_serial_ingest.py.)"""
import pytest
import torch

from _torch_common import (PROMPTS, TINY, assert_same_replay, jax_config,
                           params_pair)
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.sampler import SamplerConfig


@pytest.fixture(scope="module")
def params():
    return params_pair(TINY)


def _engine(tp, chunk=16, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 128)
    kw.setdefault("page_size", 16)
    return InferenceEngine(TINY.with_(prefill_chunk=chunk), tp, device="cpu",
                           **kw)


def _jax_engine(jp, chunk=16, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 128)
    kw.setdefault("page_size", 16)
    return JEngine(jax_config(TINY.with_(prefill_chunk=chunk)), jp,
                   kv_backend="paged", **kw)


@pytest.mark.parametrize("page", [8, 16])
def test_greedy_generate_matches_jax(params, page):
    jp, tp = params
    want = _jax_engine(jp, page_size=page).generate(PROMPTS, max_new=12)
    eng = _engine(tp, page_size=page)
    got = eng.generate(PROMPTS, max_new=12)
    assert_same_replay(got, want)
    assert eng.alloc.pages_in_use == 0


def test_generate_fanout_matches_jax(params):
    jp, tp = params
    prefix = [(i % 100) + 1 for i in range(70)]
    suffixes = [[5, 6, 7], [9], [11] * 20, []]
    want = _jax_engine(jp, max_batch=5).generate_fanout(prefix, suffixes,
                                                        max_new=8)
    eng = _engine(tp, max_batch=5)
    got = eng.generate_fanout(prefix, suffixes, max_new=8)
    assert_same_replay(got, want)
    assert eng.alloc.pages_in_use == 0


def test_batched_ragged_equals_one_row_at_a_time(params):
    _, tp = params
    batched = _engine(tp).generate(PROMPTS, max_new=10)
    single = [_engine(tp, max_batch=1).generate([p], max_new=10)[0]
              for p in PROMPTS]
    assert_same_replay(batched, single)


def test_fanout_equals_independent_submissions(params):
    _, tp = params
    prefix = [(i % 90) + 3 for i in range(40)]
    suffixes = [[4, 5], [6] * 17, [7]]
    shared = _engine(tp, max_batch=4)
    fan = shared.generate_fanout(prefix, suffixes, max_new=8)
    assert shared.alloc.pages_in_use == 0
    indep = _engine(tp, max_batch=4).generate(
        [prefix + s for s in suffixes], max_new=8)
    assert_same_replay(fan, indep)


def test_eviction_replay_equals_uninterrupted(params):
    _, tp = params
    prompts = [[65, 66, 67, 68], [70, 71], [80, 81, 82]]
    ref = _engine(tp, max_len=64, page_size=8).generate(prompts, max_new=24)
    small = _engine(tp, max_len=64, page_size=8, n_pages=6, host_swap=False)
    out = small.generate(prompts, max_new=24)
    assert small.evictions > 0 and small.swap_outs == 0
    assert_same_replay(ref, out)
    assert small.alloc.pages_in_use == 0


def test_cancel_leaves_survivors_unchanged(params):
    """Sampled streams: the engine draws noise for every row each decode
    step, so cancelling request 1 mid-decode changes no survivor's draw.
    (Logprobs agree to the replay tolerance, not bitwise: the cancel can
    narrow the live read width, which changes the plain version's
    reduction length.)"""
    _, tp = params
    sampler = SamplerConfig(temperature=0.9, top_k=20)
    prompts = [[65, 66, 67], [70, 71, 72, 73], [80, 81]]
    base = _engine(tp, sampler=sampler).generate(prompts, max_new=16)
    eng = _engine(tp, sampler=sampler)
    steps = []

    def hook(e):
        steps.append(1)
        if len(steps) == 6:
            assert e.cancel(1)
    eng.step_hook = hook
    out = eng.generate(prompts, max_new=16)
    assert eng.cancels == 1
    assert 0 < len(out[1][0]) < 16
    assert out[1][0] == base[1][0][:len(out[1][0])]
    assert_same_replay([out[0], out[2]], [base[0], base[2]])
    assert eng.alloc.pages_in_use == 0


def test_one_readback_per_decode_step(params):
    """The decode harvest is one device->host copy of the packed tokens and
    logprobs, read a step after the launch."""
    _, tp = params
    eng = _engine(tp)
    eng.add_request(0, [1, 2, 3], max_new=4)
    while eng.slots[0].prefill_toks:
        eng.step()
    n0 = len(eng.slots[0].tokens)
    assert eng.step()
    assert eng._pending_decode is not None
    assert len(eng.slots[0].tokens) == n0
    assert eng._pending_decode[1].shape == (2, eng.max_batch)
    assert eng.step()
    assert len(eng.slots[0].tokens) == n0 + 1


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_dense_backend_rejects_quantized_kv(params, kv_dtype):
    """A quantized pool needs pages (the JAX package asserts the same)."""
    _, tp = params
    with pytest.raises(ValueError):
        InferenceEngine(TINY.with_(kv_dtype=kv_dtype), tp,
                        kv_backend="dense", device="cpu")


@pytest.mark.parametrize("chunk", [0, 16])
def test_bf16_pool_under_f32_compute_matches_jax(params, chunk):
    """A float pool narrower than the compute dtype (writes cast to bf16,
    reads compute in f32): greedy tokens equal the JAX engine's. Logprobs
    are not compared: the JAX package's plain read sums the bf16 values in
    bf16, the port's in f32."""
    jp, tp = params
    cfg = TINY.with_(prefill_chunk=chunk, kv_dtype="bfloat16")
    want = JEngine(jax_config(cfg), jp, kv_backend="paged", max_batch=3,
                   max_len=128, page_size=16).generate(PROMPTS, max_new=12)
    eng = InferenceEngine(cfg, tp, max_batch=3, max_len=128, page_size=16,
                          device="cpu")
    assert eng.cache["segments"][0]["k_pages"].dtype == torch.bfloat16
    got = eng.generate(PROMPTS, max_new=12)
    assert [t for t, _ in got] == [t for t, _ in want]


def test_default_device_is_the_card(params):
    """Without a card the default device raises instead of running on the
    CPU (the tests pass device='cpu')."""
    import torch
    _, tp = params
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        InferenceEngine(TINY.with_(prefill_chunk=16), tp)
