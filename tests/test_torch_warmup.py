"""The port's `InferenceEngine.warmup()` against the JAX package's: the same
count of variant dispatches for the same config and arguments (chunked
ragged, serial and monolithic paged engines, host swap on and off, an int8
pool, the dense backend, the recurrent Mamba2 and xLSTM stacks);
state-neutral (the generator's
state, and every cache byte but the scratch page's, as they were; a warmed
engine's sampled output equal to a cold one's); a busy engine refused. And
the precondition of the decode graphs a warmed engine replays on the card:
no cache leaf or parameter changes storage while the engine serves,
evicts by swap and by replay, forks, promotes and cancels."""
import pytest
import torch

from _torch_common import (PROMPTS, SSM_CONFIGS, TINY, XLSTM, jax_config,
                           params_pair)
from repro.serving.engine import InferenceEngine as JEngine
from repro_torch.configs.pice_cloud_edge import TINY_CLOUD
from repro_torch.models import transformer
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.sampler import SamplerConfig, gumbel_noise

KW = dict(max_batch=3, max_len=64, page_size=8)
ARGS = dict(prompt_lens=(5, 20, 40), ingest_rows=(1, 3))

# name -> (config name, prefill_chunk, kv_dtype, engine keywords)
ENGINES = {
    "chunked-ragged": ("tiny", 16, "", {}),
    "chunked-serial": ("tiny", 16, "", dict(ragged_ingest=False)),
    "monolithic": ("tiny", 0, "", {}),
    "chunked-replay": ("tiny", 16, "", dict(host_swap=False)),
    "monolithic-replay": ("tiny", 0, "", dict(host_swap=False)),
    "int8-chunked": ("tiny", 16, "int8", {}),
    "fp8-monolithic": ("tiny", 0, "fp8", {}),
    "dense": ("tiny", 0, "", dict(kv_backend="dense")),
    "ssm-paged": ("tiny-edge-c", 0, "", {}),
    "ssm-dense": ("tiny-edge-c", 0, "", dict(kv_backend="dense")),
    "xlstm-paged": ("xlstm", 0, "", {}),
    "xlstm-dense": ("xlstm", 0, "", dict(kv_backend="dense")),
}
CONFIGS = {"tiny": TINY, "tiny-edge-c": SSM_CONFIGS["tiny-edge-c"],
           "xlstm": XLSTM}


@pytest.fixture(scope="module")
def params():
    return {name: params_pair(cfg) for name, cfg in CONFIGS.items()}


def _cfg(name):
    base, chunk, kv_dtype, _ = ENGINES[name]
    return CONFIGS[base].with_(prefill_chunk=chunk, kv_dtype=kv_dtype)


def _engine(params, name, **kw):
    base, _, _, extra = ENGINES[name]
    return InferenceEngine(_cfg(name), params[base][1], device="cpu",
                           **{**KW, **extra, **kw})


def _jax_engine(params, name):
    base, _, _, extra = ENGINES[name]
    kw = {"kv_backend": "paged", **KW, **extra}
    return JEngine(jax_config(_cfg(name)), params[base][0], **kw)


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_count_equals_jax_warmup(params, name):
    eng, ref = _engine(params, name), _jax_engine(params, name)
    assert eng.warmup(**ARGS) == ref.warmup(**ARGS)


@pytest.mark.parametrize("args", [
    {}, dict(max_context=20), dict(max_context=500, prompt_lens=(64,)),
    dict(ingest_rows=(1, 2, 3, 8), prompt_lens=(1, 33))])
@pytest.mark.parametrize("name", ["chunked-ragged", "monolithic", "dense"])
def test_count_equals_jax_warmup_by_arguments(params, name, args):
    eng, ref = _engine(params, name), _jax_engine(params, name)
    assert eng.warmup(**args) == ref.warmup(**args)


def _scratch_free(eng):
    """Every cache leaf, an attention pool's scratch page left out."""
    attn = {id(t) for seg in transformer.attention_segments(eng.cfg,
                                                            eng.cache)
            for t in seg.values()}
    out = []
    for t in engine_mod._tensors(eng.cache):
        if eng.kv_backend == "paged" and id(t) in attn:
            t = t[:, :-1]
        out.append(t.contiguous().view(torch.uint8).clone())
    return out


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_warmup_is_state_neutral(params, name):
    """After serving (so the pools, lengths, block table and recurrent
    states hold data), warmup() leaves the generator's state and every
    cache byte but the scratch page's as they were."""
    eng = _engine(params, name,
                  sampler=SamplerConfig(temperature=0.8, top_k=16))
    eng.generate(PROMPTS[:3], max_new=6)
    gen_state = eng.gen.get_state().clone()
    before = _scratch_free(eng)
    assert eng.warmup(**ARGS) > 0
    assert torch.equal(eng.gen.get_state(), gen_state)
    after = _scratch_free(eng)
    assert len(after) == len(before)
    for i, (a, b) in enumerate(zip(before, after)):
        assert torch.equal(a, b), f"cache leaf {i} changed"
    assert not eng._graphs, "the CPU captures no graph"


@pytest.mark.parametrize("name", ["chunked-ragged", "chunked-serial",
                                  "monolithic", "int8-chunked", "dense",
                                  "ssm-paged", "xlstm-paged", "xlstm-dense"])
def test_warmed_engine_samples_as_cold(params, name):
    """The port of tests/test_plan_run.py::test_warmup_is_state_neutral: a
    warmed engine's sampled output is bitwise a cold one's."""
    sampler = SamplerConfig(temperature=0.8, top_k=16)
    cold = _engine(params, name, sampler=sampler, max_len=128)
    warm = _engine(params, name, sampler=sampler, max_len=128)
    assert warm.warmup(ingest_rows=(1, warm.max_batch),
                       prompt_lens=(64,)) > 0
    a = cold.generate(PROMPTS, max_new=8)
    b = warm.generate(PROMPTS, max_new=8)
    for i, ((ta, la), (tb, lb)) in enumerate(zip(a, b)):
        assert ta == tb, f"request {i}: tokens diverge"
        assert la == lb, f"request {i}: logprobs diverge"


@pytest.mark.parametrize("name", ["chunked-ragged", "monolithic", "dense"])
def test_warmup_refuses_busy_engine(params, name):
    eng = _engine(params, name)
    eng.add_request(0, [1, 2, 3], max_new=4)
    with pytest.raises(AssertionError):
        eng.warmup()


def test_warmup_refuses_a_parked_prefix(params):
    eng = _engine(params, "chunked-ragged")
    slot = eng.prefill_prefix([1, 2, 3, 4, 5])
    with pytest.raises(AssertionError):
        eng.warmup()
    eng.release_prefix(slot)
    assert eng.warmup() > 0


def test_gumbel_noise_into_a_buffer_is_the_same_draw():
    """The warmed engine draws the replay's noise into a static buffer: the
    same bits a fresh draw from the same generator state gives."""
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    fresh = gumbel_noise((4, 97), g1, "cpu")
    buf = torch.empty((4, 97))
    out = gumbel_noise((4, 97), g2, "cpu", out=buf)
    assert out.data_ptr() == buf.data_ptr()
    assert torch.equal(fresh.view(torch.int32), buf.view(torch.int32))
    assert torch.equal(g1.get_state(), g2.get_state())


# ---------------------------------------------------------------------------
# the captured graphs' precondition: stable storage
# ---------------------------------------------------------------------------

TIGHT = [[65, 66, 67, 68], [70, 71], [80, 81, 82], [90, 91, 92, 93, 94]]


@pytest.fixture(scope="module")
def cloud_params():
    cfg = TINY_CLOUD.with_(dtype="float32", prefill_chunk=16)
    return cfg, transformer.init_params(cfg, seed=0, device="cpu")


def _ptrs(eng):
    return [t.data_ptr() for t in engine_mod._tensors((eng.cache,
                                                       eng.params))]


@pytest.mark.parametrize("kw", [{}, dict(host_swap=False),
                                dict(ragged_ingest=False)],
                         ids=["swap", "replay", "serial"])
def test_storage_stays_put_while_serving(cloud_params, kw):
    """TINY_CLOUD on 6 pages of 8: evicting (by swap and by replay),
    forking, promoting and cancelling leave every cache leaf and parameter
    in the storage it had, so graphs captured over them stay valid."""
    cfg, p = cloud_params
    eng = InferenceEngine(cfg, p, max_batch=3, max_len=64, page_size=8,
                          n_pages=6, device="cpu", **kw)
    ptrs = _ptrs(eng)
    eng.warmup()
    eng.generate(TIGHT, max_new=24)
    assert eng.evictions > 0
    if eng.host_swap:
        assert eng.swap_ins == eng.swap_outs > 0
    eng.generate_fanout([5, 6, 7, 8, 9, 10, 11, 12, 13], [[1], [2, 3], [4]],
                        max_new=6)
    steps = []

    def hook(e):
        steps.append(1)
        if len(steps) == 6:
            for s in e.slots:
                if s.active:
                    e.cancel(s.req_id)
                    break
    eng.step_hook = hook
    eng.generate(TIGHT, max_new=16)
    assert eng.cancels > 0
    assert _ptrs(eng) == ptrs


def test_moved_storage_is_refused(cloud_params):
    """The guard a warmed engine runs before each replay: a leaf put in
    other storage, or another sampler, raises instead of replaying a graph
    over the old pointers."""
    cfg, p = cloud_params
    eng = InferenceEngine(cfg, p, max_batch=3, max_len=64, page_size=8,
                          device="cpu")
    eng._graph_ptrs = _ptrs(eng)
    eng._graph_sampler = eng.sampler
    eng._check_captured()
    lengths = eng.cache["lengths"]
    eng.cache["lengths"] = lengths.clone()
    with pytest.raises(RuntimeError, match="moved"):
        eng._check_captured()
    eng.cache["lengths"] = lengths
    eng._check_captured()
    eng.sampler = SamplerConfig(temperature=0.5)
    with pytest.raises(RuntimeError, match="sampler"):
        eng._check_captured()


# ---------------------------------------------------------------------------
# The batched ragged ingest's graphs: one a row bucket min(2^k, max_batch),
# captured on the card only; on the CPU their body runs over the staged rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,buckets", [
    (3, [1, 2, 3]), (6, [1, 2, 4, 6]), (8, [1, 2, 4, 8]),
    (48, [1, 2, 4, 8, 16, 32, 48]), (96, [1, 2, 4, 8, 16, 32, 64, 96])])
def test_ingest_row_bucket_is_capped_power_of_two(B, buckets):
    got = {engine_mod._pow2_bucket(n, B) for n in range(1, B + 1)}
    assert sorted(got) == buckets


@pytest.mark.parametrize("B", [3, 6])
def test_ragged_ingest_call_carries_the_capped_bucket(params, monkeypatch,
                                                      B):
    """Every ingesting slot in one call of min(2^k, max_batch) rows: a
    full engine of 3 or 6 slots ingests 3 or 6 rows, not 4 or 8."""
    eng = _engine(params, "chunked-ragged", max_batch=B, max_len=128)
    seen = []
    ragged = transformer.prefill_ragged_paged

    def spy(cfg, p, toks, cache, slots, offs, lens, **kw):
        seen.append((toks.shape[0], int((slots < B).sum())))
        return ragged(cfg, p, toks, cache, slots, offs, lens, **kw)
    monkeypatch.setattr(transformer, "prefill_ragged_paged", spy)
    eng.generate([[9 + i] * 40 for i in range(B)], max_new=2)
    assert (B, B) in seen
    assert all(r == engine_mod._pow2_bucket(n, B) for r, n in seen)


def test_cpu_engine_replays_no_ingest_graph(params):
    """On the CPU nothing is captured: every ingest runs eagerly, the
    counter stays 0 and no `engine.step` span says its ingest replayed."""
    from repro_torch import trace
    eng = _engine(params, "chunked-ragged", max_len=128)
    assert eng.warmup(**ARGS) > 0
    assert not eng._ingest_graphs and eng._ingest_io is None
    trace.clear()
    trace.enable()
    try:
        eng.generate(PROMPTS, max_new=4)
        spans = [s for s in trace.spans() if s.name == "engine.step"]
    finally:
        trace.disable()
        trace.clear()
    assert eng.ingest_replays == 0
    ingests = [s for s in spans if s.attrs.get("ingest")]
    assert ingests
    assert all(s.attrs["ingest_graph"] is False for s in spans
               if "ingest_graph" in s.attrs)
    assert all("ingest_graph" in s.attrs for s in ingests)


class _Body:
    """A stand-in for a captured ingest graph on the CPU: its replay runs
    the graph's body (`InferenceEngine._ingest`) over the static buffers."""

    def __init__(self, eng, rows):
        self.eng, self.rows = eng, rows

    def replay(self):
        self.eng._ingest(self.rows)


@pytest.mark.parametrize("kv_dtype", ["", "int8"])
def test_ingest_graph_body_over_staged_rows_equals_eager(params, kv_dtype):
    """The replay path with the graphs' body in place of the graphs: the
    rows staged through the host block into the static buffers, the call at
    the full block-table width and the logits read from the static output
    give the eager call's logits, pages and lengths at every row bucket,
    over sentinel padding, partial chunks, later chunks and fork suffixes,
    and a cold engine's tokens and logprobs."""
    from _ingest_graphs import IngestSpy, drive
    cfg = TINY.with_(prefill_chunk=16, kv_dtype=kv_dtype)
    kw = dict(max_batch=6, max_len=128, page_size=16, device="cpu")
    cold = InferenceEngine(cfg, params["tiny"][1], **kw)
    warm = InferenceEngine(cfg, params["tiny"][1], **kw)
    io = engine_mod._IngestIO(6, 16, warm.device)
    io.logits = torch.empty((6, cfg.vocab_size))
    warm._ingest_io = io
    warm._graph_ptrs, warm._graph_sampler = _ptrs(warm), warm.sampler
    warm._ingest_graphs = {R: engine_mod._Graph(_Body(warm, R), [])
                           for R in (1, 2, 4, 6)}
    with IngestSpy(warm, exact=True) as spy:
        got = drive(warm)
    spy.covered([1, 2, 4, 6], chunk=16, page=16)
    assert warm.ingest_replays == len(spy.calls)
    want = drive(cold)
    assert cold.ingest_replays == 0
    assert got == want
