"""The port's xLSTM blocks and the xLSTM stack's model entry points against
the JAX package's, on the same weights and inputs (xlstm-1.3b cut to 4
layers: sLSTM, mLSTM, sLSTM, mLSTM; chunks of 16):

- `mlstm_fwd` at S = 1, 5, 16, 37, 64 from the initial state and from a
  given one, outputs and final C, n, m (at S = 37 the JAX package runs 37
  chunks of 1, the port 16 + 16 + 5); `mlstm_decode`, `slstm_fwd` and
  `slstm_decode`; a decode step keeps an inactive row's states byte for
  byte (the JAX package advances every row: a deliberate departure);
- `forward`, dense `prefill` and `decode_step`, paged `prefill_paged` and
  `decode_step_paged` (a prefill starts from the initial states whatever
  the slot held), `fork_slot_paged` copying state rows;
- decode == teacher-forced forward in the port;
- the converter's and `init_params`' leaves: r_gates and the gate biases
  in float32.

Tolerance: SSM_TOL (see _torch_common)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import SSM_TOL, XLSTM, jax_config, params_pair
from repro.models import transformer as jt
from repro.models import xlstm as jx
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.models import transformer as tt
from repro_torch.models import xlstm as tx
from repro_torch.models.config import MLSTM, SLSTM

B, N_PAGES, PAGE, P = 3, 14, 8, 6


@pytest.fixture(scope="module")
def setup():
    jp, tp = params_pair(XLSTM, seed=3)
    return XLSTM, jp, tp


def _close(a, b, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), err_msg=msg,
                               **SSM_TOL)


def _layer(cfg, jp, tp, kind):
    """The first `kind` layer's block params on both sides."""
    i = [k for k, _ in tt.segments_of(cfg)].index(kind)
    key = tt.RECURRENT_KINDS[kind]
    return (jax.tree.map(lambda a: a[0], jp["segments"][i])[key],
            tp["segments"][i][0][key])


def _state(kind, cfg, batch, rng):
    """A random state of `kind` (the sLSTM's n positive, as a scan keeps
    it), as numpy arrays."""
    if kind == MLSTM:
        _, H, hd = tx.mlstm_dims(cfg)
        shapes = {"C": (batch, H, hd, hd), "n": (batch, H, hd),
                  "m": (batch, H)}
    else:
        shapes = {k: (batch, cfg.d_model) for k in tx.SLSTM_STATE}
    out = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    if kind == SLSTM:
        out["n"] = np.abs(out["n"]) + 0.5
    return out


def _torch(state):
    return {k: torch.from_numpy(v.copy()) for k, v in state.items()}


def _jax(state):
    return {k: jnp.asarray(v) for k, v in state.items()}


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 5, 16, 37, 64])
@pytest.mark.parametrize("kind", [MLSTM, SLSTM])
def test_block_fwd_matches_jax(setup, kind, S, with_state):
    cfg, jp, tp = setup
    jl, tl = _layer(cfg, jp, tp, kind)
    rng = np.random.default_rng(S)
    u = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    st = _state(kind, cfg, 2, rng) if with_state else None
    tfwd, jfwd = ((tx.mlstm_fwd, jx.mlstm_fwd) if kind == MLSTM
                  else (tx.slstm_fwd, jx.slstm_fwd))
    to, tst = tfwd(cfg, tl, torch.from_numpy(u),
                   None if st is None else _torch(st), return_state=True)
    jo, jst = jfwd(jax_config(cfg), jl, jnp.asarray(u),
                   None if st is None else _jax(st), return_state=True)
    _close(to, jo, "out")
    assert sorted(tst) == sorted(jst)
    for k in tst:
        assert tst[k].dtype == torch.float32
        _close(tst[k], jst[k], k)


@pytest.mark.parametrize("kind", [MLSTM, SLSTM])
def test_block_decode_matches_jax(setup, kind):
    """All rows active: the JAX step, the states updated in place. Then row
    1 inactive: rows 0 and 2 as the JAX step, row 1's states kept byte for
    byte."""
    cfg, jp, tp = setup
    jl, tl = _layer(cfg, jp, tp, kind)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    st = _state(kind, cfg, 3, rng)
    tdec, jdec = ((tx.mlstm_decode, jx.mlstm_decode) if kind == MLSTM
                  else (tx.slstm_decode, jx.slstm_decode))
    jo, jst = jdec(jax_config(cfg), jl, jnp.asarray(u), _jax(st))
    for active in (None, np.array([True, False, True])):
        tst = _torch(st)
        ptrs = {k: v.data_ptr() for k, v in tst.items()}
        to = tdec(cfg, tl, torch.from_numpy(u), tst,
                  None if active is None else torch.from_numpy(active))
        assert {k: v.data_ptr() for k, v in tst.items()} == ptrs
        rows = slice(None) if active is None else active
        _close(to[rows], np.asarray(jo)[rows], "out")
        for k in tst:
            _close(tst[k][rows], np.asarray(jst[k])[rows], k)
            if active is not None:
                assert tst[k][1].numpy().tobytes() == st[k][1].tobytes(), k


def test_mlstm_chunks_cut_differently(setup):
    """At S = 37 over ssm_chunk 16 the JAX package's rule falls to chunks
    of 1; the port's 16 + 16 + 5 agree with it, and with its own chunks of
    1 (ssm_chunk=1) and of 64 (one chunk)."""
    cfg, jp, tp = setup
    _, tl = _layer(cfg, jp, tp, MLSTM)
    u = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 37, cfg.d_model)).astype(np.float32))
    want, wst = tx.mlstm_fwd(cfg, tl, u, return_state=True)
    for chunk in (1, 64):
        got, gst = tx.mlstm_fwd(cfg.with_(ssm_chunk=chunk), tl, u,
                                return_state=True)
        _close(got, want, f"chunk {chunk}")
        for k in wst:
            _close(gst[k], wst[k], f"chunk {chunk}: {k}")


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def test_forward_matches_jax(setup):
    cfg, jp, tp = setup
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 37))
    tl, taux = tt.forward(cfg, tp, torch.from_numpy(toks))
    jl, jaux = jt.forward(jax_config(cfg), jp, jnp.asarray(toks))
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0


def _fill(tc, jc, rng):
    """The same random states in every cache leaf on both sides (the
    sLSTM's n positive)."""
    for tseg, jseg in zip(tc["segments"], jc["segments"]):
        for k in tseg:
            a = rng.standard_normal(tuple(tseg[k].shape)).astype(np.float32)
            if k == "n" and tseg[k].dim() == 3:
                a = np.abs(a) + 0.5
            tseg[k].copy_(torch.from_numpy(a))
            jseg[k] = jnp.asarray(a)


def _states(cache):
    return [{k: v.numpy().copy() for k, v in seg.items()}
            for seg in cache["segments"]]


def _same(tc, jc, keep_rows=None, before=None):
    """Equal lengths and states; with `keep_rows` (inactive rows of a
    decode), those rows equal `before`'s byte for byte instead."""
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    for i, (tseg, jseg) in enumerate(zip(tc["segments"], jc["segments"])):
        assert sorted(tseg) == sorted(jseg)
        for k in tseg:
            t, j = tseg[k], np.asarray(jseg[k])
            if keep_rows is None:
                _close(t, j, k)
                continue
            _close(t[:, ~keep_rows], j[:, ~keep_rows], k)
            assert (t[:, keep_rows].numpy().tobytes()
                    == before[i][k][:, keep_rows].tobytes()), k


def test_prefill_matches_jax(setup):
    """Right-padded prompts into a cache holding other states: the states
    after all S positions from the initial ones, as the JAX package's
    prefill computes them into a fresh cache."""
    cfg, jp, tp = setup
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 37))
    plens = np.array([37, 20], np.int32)
    tc = tt.init_cache(cfg, 2, 48)
    jc = jt.init_cache(jax_config(cfg), 2, 48)
    _fill(tc, jc, np.random.default_rng(5))
    jc = jt.init_cache(jax_config(cfg), 2, 48)
    tl, tc = tt.prefill(cfg, tp, torch.from_numpy(toks), tc,
                        torch.from_numpy(plens))
    jl, jc = jt.prefill(jax_config(cfg), jp, jnp.asarray(toks), jc,
                        prompt_lengths=jnp.asarray(plens))
    _close(tl, jl)
    _same(tc, jc)


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
    """The same random states, lengths and block table on both sides."""
    tc = tt.init_paged_cache(cfg, B, N_PAGES, PAGE, P)
    jc = jt.init_paged_cache(jax_config(cfg), B, N_PAGES, PAGE, P)
    _fill(tc, jc, np.random.default_rng(seed))
    table = np.full((B, P), -1, np.int32)
    table[0, :3] = [4, 1, 9]
    table[2, :4] = [4, 3, 11, 12]
    lengths = np.array([11, 0, 17], np.int32)
    tc["block_table"].copy_(torch.from_numpy(table))
    tc["lengths"].copy_(torch.from_numpy(lengths))
    jc["block_table"], jc["lengths"] = jnp.asarray(table), jnp.asarray(lengths)
    return tc, jc


def test_prefill_paged_matches_jax(setup):
    """A 37-token prompt into slot 1, which holds other states: its rows
    from the initial states, the other slots' rows untouched."""
    cfg, jp, tp = setup
    tc, jc = _paged_caches(cfg, 7)
    table = np.asarray(jc["block_table"]).copy()
    table[1, :5] = [5, 13, 6, 0, 2]
    tc["block_table"].copy_(torch.from_numpy(table))
    jc["block_table"] = jnp.asarray(table)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 37))
    tl, tc = tt.prefill_paged(cfg, tp, torch.from_numpy(toks), tc, 1, 37)
    jl, jc = jt.prefill_paged(jax_config(cfg), jp, jnp.asarray(toks), jc, 1,
                              37)
    _close(tl, jl)
    _same(tc, jc)


@pytest.mark.parametrize("live_pages", [None, 4])
def test_decode_step_paged_matches_jax(setup, live_pages):
    """Row 1 inactive: its states stay, byte for byte."""
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
    for seg in tt.state_segments(cfg, tc):
        for leaf in seg.values():
            assert torch.equal(leaf[:, 1], leaf[:, 0])
    assert tt.attention_segments(cfg, tc) == []


@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("S0", [5, 37])
def test_decode_matches_forward(setup, backend, S0):
    """Prefill S0 tokens, decode 5 one at a time == teacher-forced
    forward."""
    cfg, _, tp = setup
    Bb, N, MAX = 2, 5, 64
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (Bb, S0 + N)))
    if backend == "dense":
        cache = tt.init_cache(cfg, Bb, MAX)
        logits, cache = tt.prefill(cfg, tp, toks[:, :S0], cache)
        step = tt.decode_step
    else:
        cache = tt.init_paged_cache(cfg, Bb, 2 * MAX // PAGE, PAGE,
                                    MAX // PAGE)
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


def test_chunked_prefill_refuses_xlstm(setup):
    cfg, _, tp = setup
    assert tt.is_recurrent(cfg)
    cache = tt.init_paged_cache(cfg, 2, 4, 8, 2)
    toks = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError):
        tt.prefill_chunk_paged(cfg, tp, toks, cache, 0, 0, 8)
    with pytest.raises(ValueError):
        tt.prefill_ragged_paged(cfg, tp, toks, cache, [0], [0], [8])


def test_full_width_config_serves_paged():
    """xlstm-1.3b's head_dim of 512 sizes mLSTM states, not K/V: the paged
    contract holds at page 32 and max_len 1,024."""
    cfg = get_config("xlstm-1.3b")
    assert cfg.n_layers == 48 and cfg.d_model == 2048
    assert cfg.block_pattern().count(SLSTM) == 6
    cfg.validate_paged(32, 1024)
    tt.check_paged_supported(cfg)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

F32_LEAVES = {MLSTM: ("b_i", "b_f", "norm_scale"),
              SLSTM: ("r_gates", "b_gates", "norm_scale")}


def test_converted_leaves_keep_their_working_dtypes():
    """Under a bf16 compute dtype: the gate biases, r_gates and the norm
    scales in float32, the projections in bf16."""
    cfg = XLSTM.with_(dtype="bfloat16")
    jp = jt.init_params(jax_config(cfg), jax.random.PRNGKey(0))
    tp = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    assert [k for k, _ in tt.segments_of(cfg)] == [SLSTM, MLSTM, SLSTM,
                                                   MLSTM]
    for (kind, _), seg in zip(tt.segments_of(cfg), tp["segments"]):
        block = seg[0][tt.RECURRENT_KINDS[kind]]
        assert seg[0]["norm1"]["scale"].dtype == torch.float32
        for k, leaf in block.items():
            want = (torch.float32 if k in F32_LEAVES[kind]
                    else torch.bfloat16)
            assert leaf.dtype == want, (kind, k)


def test_init_params_matches_converted_layout(setup):
    """The port's own random init has the converter's structure, shapes
    and dtypes, under float32 and under bf16, and its constant inits."""
    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)
    cfg, _, tp = setup
    own = tt.init_params(cfg, seed=0, device="cpu")
    assert shapes(own) == shapes(tp)
    bf = cfg.with_(dtype="bfloat16")
    jp = jt.init_params(jax_config(bf), jax.random.PRNGKey(0))
    conv = convert.params_from_reference(bf, jax.tree.map(np.asarray, jp),
                                         device="cpu")
    assert shapes(tt.init_params(bf, seed=0, device="cpu")) == shapes(conv)
    d = cfg.d_model
    s, m = own["segments"][0][0]["slstm"], own["segments"][1][0]["mlstm"]
    want = torch.cat([torch.zeros(d), torch.full((d,), 3.0),
                      torch.zeros(2 * d)])
    assert torch.equal(s["b_gates"], want)
    assert torch.equal(m["b_f"], torch.full_like(m["b_f"], 3.0))
    assert torch.equal(m["b_i"], torch.zeros_like(m["b_i"]))
