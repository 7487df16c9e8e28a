"""The port's Mamba2 block and recurrent model entry points against the JAX
package's, on the same weights and inputs, for TINY_EDGE_C (pure Mamba2)
and zamba2 cut to 4 Mamba2 layers with its shared attention block applied
twice: `mamba2_fwd` / `mamba2_decode`, `forward`, dense `prefill` and
`decode_step`, paged `prefill_paged` and `decode_step_paged` (the same
padded inputs: the model scans the padding, as the JAX package does), and
`fork_slot_paged` copying state rows; decode == teacher-forced forward in
the port; decode with an inactive row keeps that row's states (the JAX
package advances them: a deliberate departure); the converter's and
`init_params`' leaves. Tolerance: SSM_TOL (see _torch_common)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import SSM_CONFIGS, SSM_TOL, jax_config, params_pair
from repro.models import ssm as js
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.models import ssm as ts
from repro_torch.models import transformer as tt
from repro_torch.models.config import MAMBA2, SHARED_ATTN

B, N_PAGES, PAGE, P = 3, 14, 8, 6


@pytest.fixture(scope="module", params=sorted(SSM_CONFIGS))
def setup(request):
    cfg = SSM_CONFIGS[request.param]
    jp, tp = params_pair(cfg, seed=3)
    return cfg, jp, tp


def _close(a, b, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), err_msg=msg,
                               **SSM_TOL)


def _mamba_layer(cfg, jp, tp):
    """The first Mamba2 layer's params on both sides."""
    i = [k for k, _ in tt.segments_of(cfg)].index(MAMBA2)
    return (jax.tree.map(lambda a: a[0], jp["segments"][i])["mamba"],
            tp["segments"][i][0]["mamba"])


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_fwd_matches_jax(setup, with_state):
    cfg, jp, tp = setup
    jm, tm = _mamba_layer(cfg, jp, tp)
    inner, H, Ph, N = ts.ssm_dims(cfg)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    conv = ssd = None
    if with_state:
        conv = rng.standard_normal((2, cfg.ssm_conv - 1, inner)).astype(
            np.float32)
        ssd = rng.standard_normal((2, H, Ph, N)).astype(np.float32)
    to, tc, tsd = ts.mamba2_fwd(
        cfg, tm, torch.from_numpy(u),
        None if conv is None else torch.from_numpy(conv),
        None if ssd is None else torch.from_numpy(ssd), return_state=True)
    jo, jc, jsd = js.mamba2_fwd(
        jax_config(cfg), jm, jnp.asarray(u),
        None if conv is None else jnp.asarray(conv),
        None if ssd is None else jnp.asarray(ssd), return_state=True)
    _close(to, jo, "out")
    _close(tc, jc, "conv")
    _close(tsd, jsd, "ssd")
    assert tsd.dtype == torch.float32


def test_mamba2_decode_matches_jax(setup):
    """All rows active: the JAX step. Then row 1 inactive: rows 0 and 2 as
    the JAX step, row 1's states kept bit for bit."""
    cfg, jp, tp = setup
    jm, tm = _mamba_layer(cfg, jp, tp)
    inner, H, Ph, N = ts.ssm_dims(cfg)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, cfg.ssm_conv - 1, inner)).astype(
        np.float32)
    ssd = rng.standard_normal((3, H, Ph, N)).astype(np.float32)
    jo, jc, jsd = js.mamba2_decode(jax_config(cfg), jm, jnp.asarray(u),
                                   jnp.asarray(conv), jnp.asarray(ssd))
    for active in (None, np.array([True, False, True])):
        tc, tsd = torch.from_numpy(conv.copy()), torch.from_numpy(ssd.copy())
        to, tc2, tsd2 = ts.mamba2_decode(
            cfg, tm, torch.from_numpy(u), tc, tsd,
            None if active is None else torch.from_numpy(active))
        assert tc2 is tc and tsd2 is tsd            # updated in place
        rows = slice(None) if active is None else active
        _close(to[rows], np.asarray(jo)[rows], "out")
        _close(tc[rows], np.asarray(jc)[rows], "conv")
        _close(tsd[rows], np.asarray(jsd)[rows], "ssd")
        if active is not None:
            np.testing.assert_array_equal(tc[1].numpy(), conv[1])
            np.testing.assert_array_equal(tsd[1].numpy(), ssd[1])


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_jax(setup, use_pallas):
    """The JAX side with use_pallas runs its SSD (and flash) kernels in
    interpret mode."""
    cfg, jp, tp = setup
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 24))
    tl, taux = tt.forward(cfg, tp, torch.from_numpy(toks))
    jl, jaux = jt.forward(jax_config(cfg.with_(use_pallas=use_pallas)), jp,
                          jnp.asarray(toks))
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0


def _fill(tc, jc, rng):
    """The same random values in every cache leaf on both sides (the port's
    pools carry one more page, which the JAX side takes as a page it never
    maps)."""
    for tseg, jseg in zip(tc["segments"], jc["segments"]):
        for k in tseg:
            a = rng.standard_normal(tuple(tseg[k].shape)).astype(np.float32)
            tseg[k].copy_(torch.from_numpy(a))
            jseg[k] = jnp.asarray(a)


def _same(tc, jc, keep_rows=None, before=None):
    """Equal lengths, pools (but the port's scratch page) and states; with
    `keep_rows` (inactive rows of a decode), those state rows equal
    `before`'s instead of the JAX package's, and a dense cache's K/V is
    compared on the other rows only: an inactive row's output is
    unspecified, so what it writes into its freed dense rows differs."""
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    for i, (tseg, jseg) in enumerate(zip(tc["segments"], jc["segments"])):
        for k in tseg:
            t, j = tseg[k], np.asarray(jseg[k])
            if k in ("k_pages", "v_pages"):
                _close(t[:, :-1], j[:, :-1], k)
                continue
            if keep_rows is None:
                _close(t, j, k)
                continue
            live = ~keep_rows
            _close(t[:, live], j[:, live], k)
            if k in ("conv", "ssd"):
                np.testing.assert_array_equal(
                    t[:, keep_rows].numpy(), before[i][k][:, keep_rows], k)


def test_prefill_matches_jax(setup):
    """Right-padded prompts: K/V rows zeros past S, the Mamba2 states after
    all S positions, as in the JAX package."""
    cfg, jp, tp = setup
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
    plens = np.array([16, 9], np.int32)
    tc = tt.init_cache(cfg, 2, 24)
    jc = jt.init_cache(jax_config(cfg), 2, 24)
    _fill(tc, jc, np.random.default_rng(5))
    jc = jt.init_cache(jax_config(cfg), 2, 24)       # JAX: a fresh cache
    tl, tc = tt.prefill(cfg, tp, torch.from_numpy(toks), tc,
                        torch.from_numpy(plens))
    jl, jc = jt.prefill(jax_config(cfg), jp, jnp.asarray(toks), jc,
                        prompt_lengths=jnp.asarray(plens))
    _close(tl, jl)
    _same(tc, jc)


def _states(cache):
    return [{k: v.numpy().copy() for k, v in seg.items()}
            for seg in cache["segments"]]


@pytest.mark.parametrize("active", [None, [True, False, True]])
def test_decode_step_matches_jax(setup, active):
    cfg, jp, tp = setup
    tc = tt.init_cache(cfg, 3, 20)
    jc = jt.init_cache(jax_config(cfg), 3, 20)
    _fill(tc, jc, np.random.default_rng(6))
    lens = np.array([7, 3, 12], np.int32)
    tc["lengths"].copy_(torch.from_numpy(lens))
    jc["lengths"] = jnp.asarray(lens)
    before = _states(tc)
    toks = np.array([[3], [9], [27]])
    act = None if active is None else np.array(active)
    tl, tc = tt.decode_step(cfg, tp, torch.from_numpy(toks), tc,
                            active=None if act is None
                            else torch.from_numpy(act))
    jl, jc = jt.decode_step(jax_config(cfg), jp, jnp.asarray(toks), jc,
                            active=None if act is None else jnp.asarray(act))
    rows = slice(None) if act is None else act
    _close(tl[rows], np.asarray(jl)[rows])
    _same(tc, jc, None if act is None else ~act, before)


def _paged_caches(cfg, seed):
    """The same random pools, states, lengths and block table on both
    sides (slot 2 shares slot 0's first page)."""
    tc = tt.init_paged_cache(cfg, B, N_PAGES, PAGE, P)
    jc = jt.init_paged_cache(jax_config(cfg), B, N_PAGES, PAGE, P)
    _fill(tc, jc, np.random.default_rng(seed))
    table = np.full((B, P), -1, np.int32)
    table[0, :3] = [4, 1, 9]
    table[1, :2] = [2, 7]
    table[2, :4] = [4, 3, 11, 12]
    lengths = np.array([11, 0, 17], np.int32)
    tc["block_table"].copy_(torch.from_numpy(table))
    tc["lengths"].copy_(torch.from_numpy(lengths))
    jc["block_table"], jc["lengths"] = jnp.asarray(table), jnp.asarray(lengths)
    return tc, jc


def test_prefill_paged_matches_jax(setup):
    """One padded prompt into slot 1: its pages and state rows; the other
    slots' rows untouched."""
    cfg, jp, tp = setup
    tc, jc = _paged_caches(cfg, 7)
    table = np.asarray(jc["block_table"]).copy()
    table[1, :3] = [5, 13, 6]
    tc["block_table"].copy_(torch.from_numpy(table))
    jc["block_table"] = jnp.asarray(table)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 32))
    tl, tc = tt.prefill_paged(cfg, tp, torch.from_numpy(toks), tc, 1, 19)
    jl, jc = jt.prefill_paged(jax_config(cfg), jp, jnp.asarray(toks), jc, 1,
                              19)
    _close(tl, jl)
    _same(tc, jc)


@pytest.mark.parametrize("live_pages", [None, 4])
def test_decode_step_paged_matches_jax(setup, live_pages):
    """Row 1 inactive: its K/V writes drop and its states stay."""
    cfg, jp, tp = setup
    tc, jc = _paged_caches(cfg, 9)
    before = _states(tc)
    toks = np.array([[3], [9], [27]])
    active = np.array([True, False, True])
    tl, tc = tt.decode_step_paged(cfg, tp, torch.from_numpy(toks), tc,
                                  active=torch.from_numpy(active),
                                  live_pages=live_pages)
    jl, jc = jt.decode_step_paged(jax_config(cfg), jp, jnp.asarray(toks), jc,
                                  active=jnp.asarray(active),
                                  live_pages=live_pages)
    _close(tl[active], np.asarray(jl)[active])
    _same(tc, jc, ~active, before)


def test_fork_slot_paged_copies_state_rows(setup):
    cfg, _, _ = setup
    tc, jc = _paged_caches(cfg, 10)
    tc = tt.fork_slot_paged(cfg, tc, 0, 1, 9, 7)
    jc = jt.fork_slot_paged(jax_config(cfg), jc, 0, 1, 9, 7)
    _same(tc, jc)
    for seg in tc["segments"]:
        if "ssd" in seg:
            torch.testing.assert_close(seg["ssd"][:, 1], seg["ssd"][:, 0],
                                       rtol=0, atol=0)
    tc = tt.fork_slot_paged(cfg, tc, 2, 2, 3, 3)       # a COW copy: no-op
    jc = jt.fork_slot_paged(jax_config(cfg), jc, 2, 2, 3, 3)
    _same(tc, jc)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_decode_matches_forward(setup, backend):
    """Prefill 8 tokens, decode 5 one at a time == teacher-forced forward
    (tests/test_models.py::test_decode_matches_forward, in the port)."""
    cfg, _, tp = setup
    Bb, S0, N, MAX = 2, 8, 5, 64
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (Bb, S0 + N)))
    if backend == "dense":
        cache = tt.init_cache(cfg, Bb, MAX)
        logits, cache = tt.prefill(cfg, tp, toks[:, :S0], cache)
        step = tt.decode_step
    else:
        cache = tt.init_paged_cache(cfg, Bb, 2 * MAX // PAGE, PAGE,
                                    MAX // PAGE)
        pages = torch.arange(2 * MAX // PAGE, dtype=torch.int32)
        cache["block_table"].copy_(pages.reshape(Bb, MAX // PAGE))
        rows = []
        for b in range(Bb):
            lg, cache = tt.prefill_paged(cfg, tp, toks[b:b + 1, :S0], cache,
                                         b, S0)
            rows.append(lg)
        logits = torch.cat(rows)
        step = tt.decode_step_paged
    outs = [logits]
    for i in range(N):
        logits, cache = step(cfg, tp, toks[:, S0 + i:S0 + i + 1], cache)
        outs.append(logits)
    dec = torch.stack(outs[:-1], 1)
    fw, _ = tt.forward(cfg, tp, toks)
    _close(dec, fw[:, S0 - 1:S0 + N - 1])


def test_chunked_prefill_refuses_recurrent_stacks(setup):
    cfg, _, tp = setup
    cache = tt.init_paged_cache(cfg, 2, 4, 8, 2)
    toks = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError):
        tt.prefill_chunk_paged(cfg, tp, toks, cache, 0, 0, 8)
    with pytest.raises(ValueError):
        tt.prefill_ragged_paged(cfg, tp, toks, cache, [0], [0], [8])


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def test_converted_leaves_keep_their_working_dtypes():
    """Under a bf16 compute dtype: A_log, D, dt_bias and the norm scales in
    float32, the projections and the conv in bf16; the shared block once,
    its segments empty."""
    cfg = SSM_CONFIGS["zamba2-4l"].with_(dtype="bfloat16")
    jp = jt.init_params(jax_config(cfg), jax.random.PRNGKey(0))
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    kinds = [k for k, _ in tt.segments_of(cfg)]
    assert kinds == [MAMBA2, SHARED_ATTN, MAMBA2, SHARED_ATTN]
    assert [len(s) for s in tp["segments"]] == [2, 0, 2, 0]
    m = tp["segments"][0][0]["mamba"]
    for k in ("A_log", "D", "dt_bias", "norm_scale"):
        assert m[k].dtype == torch.float32, k
    for k in ("w_in", "w_out", "conv_w", "conv_b"):
        assert m[k].dtype == torch.bfloat16, k
    assert tp["shared"]["attn"]["wq"].dtype == torch.bfloat16
    assert tp["shared"]["norm1"]["scale"].dtype == torch.float32


def test_init_params_matches_converted_layout(setup):
    """The port's own random init has the converter's structure, shapes
    and dtypes."""
    cfg, _, tp = setup
    own = tt.init_params(cfg, seed=0, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)
    assert shapes(own) == shapes(tp)
