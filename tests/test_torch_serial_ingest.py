"""The port's serial one-chunk scheduler (`ragged_ingest=False`) against the
JAX package's on the same weights, and the port's own three-way invariant
batched ragged == serial chunk == monolithic (tests/test_plan_run.py's,
here at the replay tolerance: the JAX package's bitwise form of it fails on
this JAX, ROADMAP §3). The serial step feeds one chunk of the most urgent
ingesting slot (highest priority, then oldest admission) through
`prefill_chunk_paged`, and that slot joins the decode batch in the same
step."""
import numpy as np
import pytest
import torch

from _torch_common import (PROMPTS, TINY, assert_same_replay, jax_config,
                           params_pair)
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.serving.engine import InferenceEngine


@pytest.fixture(scope="module")
def params():
    return params_pair(TINY)


def _engine(tp, chunk=16, kv_dtype="", **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 128)
    kw.setdefault("page_size", 16)
    return InferenceEngine(TINY.with_(prefill_chunk=chunk, kv_dtype=kv_dtype),
                           tp, device="cpu", **kw)


def _jax_engine(jp, chunk=16, kv_dtype="", **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 128)
    kw.setdefault("page_size", 16)
    cfg = TINY.with_(prefill_chunk=chunk, kv_dtype=kv_dtype)
    return JEngine(jax_config(cfg), jp, kv_backend="paged", **kw)


@pytest.mark.parametrize("chunk,page", [(16, 8), (48, 16)])
def test_serial_matches_jax_serial(params, chunk, page):
    jp, tp = params
    want = _jax_engine(jp, chunk, page_size=page,
                       ragged_ingest=False).generate(PROMPTS, max_new=12)
    eng = _engine(tp, chunk, page_size=page, ragged_ingest=False)
    got = eng.generate(PROMPTS, max_new=12)
    assert_same_replay(got, want)
    assert eng.alloc.pages_in_use == 0


@pytest.mark.parametrize("chunk", [16, 48])
@pytest.mark.parametrize("page", [8, 16])
def test_three_way_greedy(params, chunk, page):
    _, tp = params
    mono = _engine(tp, 0, page_size=page).generate(PROMPTS, max_new=12)
    serial_eng = _engine(tp, chunk, page_size=page, ragged_ingest=False)
    serial = serial_eng.generate(PROMPTS, max_new=12)
    batched = _engine(tp, chunk, page_size=page).generate(PROMPTS,
                                                          max_new=12)
    assert_same_replay(serial, mono)
    assert_same_replay(batched, mono)
    assert serial_eng.alloc.pages_in_use == 0


@pytest.mark.parametrize("B", [5, 6])
def test_three_way_at_capped_row_buckets(params, B):
    """The three-way invariant where the ragged call's row bucket is capped
    at max_batch (5 or 6 rows, not 8), with six prompts and a fan-out of
    B - 1 suffixes at once."""
    _, tp = params
    prompts = [[(13 * i + j) % 97 + 1 for j in range(n)]
               for i, n in enumerate((37, 16, 40, 70, 23, 100))]
    prefix = [(i % 90) + 3 for i in range(29)]
    suffixes = [[4 + i] * (3 + 7 * i) for i in range(B - 1)]
    out = {}
    for name, chunk, kw in (("mono", 0, {}), ("serial", 16,
                                              dict(ragged_ingest=False)),
                            ("batched", 16, {})):
        eng = _engine(tp, chunk, max_batch=B, **kw)
        out[name] = (eng.generate(prompts, max_new=10)
                     + eng.generate_fanout(prefix, suffixes, max_new=8))
    assert_same_replay(out["serial"], out["mono"])
    assert_same_replay(out["batched"], out["mono"])


def test_three_way_fork_suffixes(params):
    jp, tp = params
    prefix = [(i % 100) + 1 for i in range(70)]
    suffixes = [[5, 6, 7], [9], [11] * 20]
    serial = _engine(tp, max_batch=4, ragged_ingest=False).generate_fanout(
        prefix, suffixes, max_new=8)
    batched = _engine(tp, max_batch=4).generate_fanout(prefix, suffixes,
                                                       max_new=8)
    mono = _engine(tp, 0, max_batch=4).generate_fanout(prefix, suffixes,
                                                       max_new=8)
    want = _jax_engine(jp, max_batch=4, ragged_ingest=False).generate_fanout(
        prefix, suffixes, max_new=8)
    assert_same_replay(serial, batched)
    assert_same_replay(serial, mono)
    assert_same_replay(serial, want)


@pytest.mark.parametrize("host_swap", [True, False])
def test_serial_eviction_resume_equals_uninterrupted(params, host_swap):
    """A starved pool under the serial scheduler, resumed by swap or by
    replay, against the JAX serial engine and a roomy pool."""
    jp, tp = params
    prompts = [[65, 66, 67, 68], [70, 71], [80, 81, 82]]
    kw = dict(max_len=64, page_size=8)
    ref = _engine(tp, **kw).generate(prompts, max_new=24)
    eng = _engine(tp, n_pages=6, ragged_ingest=False, host_swap=host_swap,
                  **kw)
    got = eng.generate(prompts, max_new=24)
    want = _jax_engine(jp, n_pages=6, ragged_ingest=False,
                       host_swap=host_swap, **kw).generate(prompts,
                                                           max_new=24)
    assert eng.evictions > 0
    assert (eng.swap_outs > 0) == host_swap
    assert_same_replay(got, ref)
    assert_same_replay(got, want)
    assert eng.alloc.pages_in_use == 0 and not eng.alloc.hosted


def test_serial_int8_pool_matches_jax(params):
    jp, tp = params
    got = _engine(tp, kv_dtype="int8", ragged_ingest=False).generate(
        PROMPTS[:3], max_new=8)
    want = _jax_engine(jp, kv_dtype="int8", ragged_ingest=False).generate(
        PROMPTS[:3], max_new=8)
    for (tg, lg), (tw, lw) in zip(got, want):
        assert tg == tw
        np.testing.assert_allclose(lg, lw, rtol=0, atol=1e-2)


def test_one_chunk_a_step_most_urgent_first(params):
    """Each step ingests one chunk: the highest-priority slot's, then the
    oldest's; a slot whose last chunk lands joins that step's decode."""
    _, tp = params
    eng = _engine(tp, ragged_ingest=False)
    eng.add_request(0, list(range(1, 41)), max_new=20)            # 3 chunks
    eng.add_request(1, list(range(1, 20)), max_new=20)            # 2 chunks
    eng.add_request(2, list(range(1, 18)), max_new=20, priority=1)  # 2
    order = []
    real = eng._ingest_chunk

    def spy(slot):
        order.append(slot)
        return real(slot)
    eng._ingest_chunk = spy
    decoded = []                          # each step's decode batch
    real_plan = eng._plan_decode

    def plan(active):
        decoded[-1] = list(active)
        return real_plan(active)
    eng._plan_decode = plan
    for _ in range(7):
        decoded.append([])
        eng.step()
    assert order == [2, 2, 0, 0, 0, 1, 1]
    # a slot joins the decode batch in the step its last chunk lands
    assert decoded == [[], [2], [2], [2], [0, 2], [0, 2], [0, 1, 2]]


def test_one_readback_per_decode_step(params, monkeypatch):
    """Steps with no finishing chunk read back only the previous decode;
    a step whose final chunk lands adds one read of its first token."""
    _, tp = params
    eng = _engine(tp, ragged_ingest=False)
    eng.add_request(0, [1, 2, 3], max_new=6)
    eng.add_request(1, [4, 5], max_new=6)
    reads = []
    real_cpu = torch.Tensor.cpu

    def counted(t, *a, **kw):
        reads.append(tuple(t.shape))
        return real_cpu(t, *a, **kw)
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    assert eng.step() and reads == [(2, 1)]      # slot 0's first token
    reads.clear()
    assert eng.step() and reads == [(2, eng.max_batch), (2, 1)]
    for _ in range(3):
        reads.clear()
        assert eng.step()
        assert reads == [(2, eng.max_batch)]
