"""The backward kernels' plain versions and the Python side of their
`torch.autograd.Function`s, on the CPU.

Each plain backward (`rmsnorm_bwd_ref`, `flash_attention_bwd_ref`,
`ssd_bwd_ref`) is held against torch.autograd through the port's plain
forward and against `jax.vjp` of the JAX package's function (`rmsnorm_ref`,
`mha_ref`, `ssd_chunked_ref`). The Functions run on the CPU only inside
these tests: `runtime.use_kernel` is patched to say "kernel" and each
`*_cuda` launcher is replaced by its plain version (checking the layouts
the real launcher demands), so the shapes, the GQA head sums, the
log-sum-exp hand-off, the launch counters and the raises are exercised
without a card; the package itself has no such switch.

Tolerances, all in float32: against autograd through the same plain
forward rtol = atol = 1e-5 (the same function, sums in another order);
against jax.vjp the same for RMSNorm and attention, and for the SSD scan
1e-4 relative to each gradient's largest magnitude (the per-token
recurrence against the JAX chunked form: exps of cumulative sums, the scan
kernels' own tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common as tc
from repro.kernels.flash_attention import ref as jfa
from repro.kernels.rmsnorm import ref as jrms
from repro.kernels.ssm_scan import ref as jssd
from repro_torch.configs.pice_cloud_edge import TINY_CLOUD, TINY_EDGE_C
from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import ops as faops
from repro_torch.kernels.flash_attention import ref as faref
from repro_torch.kernels.rmsnorm import ops as rops
from repro_torch.kernels.rmsnorm import ref as rref
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.kernels.ssm_scan import ref as sref
from repro_torch.launch import steps
from repro_torch.models import transformer
from repro_torch.training import tree as tree_lib

TOL = dict(rtol=1e-5, atol=1e-5)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _autograd(fn, inputs, couts):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, couts))
    return [g.numpy() for g in torch.autograd.grad(total, leaves)]


def _vjp(fn, inputs, couts):
    out, pull = jax.vjp(fn, *[jnp.asarray(a) for a in inputs])
    cot = tuple(jnp.asarray(c) for c in couts)
    return [np.asarray(g) for g in pull(cot if isinstance(out, tuple)
                                        else cot[0])]


# ---------------------------------------------------------------------------
# plain backwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 16), (2, 7, 96), (3, 4, 2, 24)])
def test_rmsnorm_bwd_ref_matches_autograd_and_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    got = rref.rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(g), 1e-6)
    assert got[0].dtype == torch.float32 and got[1].shape == scale.shape
    for want in (_autograd(lambda a, s: rref.rmsnorm_ref(a, s, 1e-6),
                           (x, scale), (g,)),
                 _vjp(lambda a, s: jrms.rmsnorm_ref(a, s, 1e-6), (x, scale),
                      (g,))):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b, **TOL)


FLASH_CASES = [(2, 13, 4, 2, 8, True, 0, 0.0), (1, 20, 6, 1, 16, True, 5, 0.0),
               (2, 9, 3, 3, 24, False, 0, 0.0), (1, 17, 4, 2, 8, True, 0, 2.0),
               (1, 12, 2, 1, 12, False, 4, 3.0)]


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window,softcap", FLASH_CASES)
def test_flash_bwd_ref_matches_autograd_and_jax(B, S, Hq, Hkv, hd, causal,
                                                window, softcap):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = faref.flash_attention_lse_ref(*map(torch.from_numpy, (q, k, v)),
                                           **kw)
    got = faref.flash_attention_bwd_ref(*map(torch.from_numpy, (q, k, v)), o,
                                        lse, torch.from_numpy(do), **kw)
    # the log-sum-exp: the log of the softmax's normaliser, from the JAX
    # package's scores (mha_ref's steps)
    kr = np.repeat(k, Hq // Hkv, axis=2)
    s = jnp.einsum("bqnh,bknh->bnqk", q, kr) / np.sqrt(np.float32(hd))
    if softcap:
        s = jnp.tanh(s / softcap) * softcap
    qi, ki = np.arange(S)[:, None], np.arange(S)[None, :]
    keep = (ki <= qi) if causal else np.ones((S, S), bool)
    if window:
        keep = keep & (ki > qi - window)
    want_lse = jax.nn.logsumexp(jnp.where(keep, s, jfa.NEG_INF), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)
    for want in (_autograd(lambda a, b, c: faref.flash_attention_ref(a, b, c,
                                                                     **kw),
                           (q, k, v), (do,)),
                 _vjp(lambda a, b, c: jfa.mha_ref(a, b, c, **kw), (q, k, v),
                      (do,))):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b, **TOL)


def _bf16(a):
    """float32 values on the bfloat16 grid (what the card's kernels read)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# the bf16 kernel's rounding model beside FLASH_CASES: qwen2-1.5b's group
# (12 query over 2 kv heads of 128) at S 128, and a softcap of 30
MMA_CASES = FLASH_CASES + [(1, 128, 12, 2, 128, True, 0, 0.0),
                           (2, 40, 4, 1, 32, True, 0, 30.0)]


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window,softcap", MMA_CASES)
def test_flash_bwd_mma_model_within_bf16_gate_of_jax(B, S, Hq, Hkv, hd,
                                                     causal, window,
                                                     softcap):
    """`flash_attention_bwd_mma_ref` (P and scale dU rounded to bf16 before
    their products, as the tensor-core kernel rounds them) against jax.vjp
    of the JAX package's `mha_ref` in float32, on inputs on the bf16 grid
    and the forward's output rounded to bf16 as the kernel receives it:
    within the card's bf16 gate, 2e-2 of each gradient's largest magnitude
    (at least 1 % of the largest among the three)."""
    rng = np.random.default_rng(8)
    q, k, v, do = (_bf16(rng.standard_normal(sh).astype(np.float32))
                   for sh in ((B, S, Hq, hd), (B, S, Hkv, hd),
                              (B, S, Hkv, hd), (B, S, Hq, hd)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = faref.flash_attention_lse_ref(*map(torch.from_numpy, (q, k, v)),
                                           **kw)
    o = o.to(torch.bfloat16).float()
    got = faref.flash_attention_bwd_mma_ref(
        *map(torch.from_numpy, (q, k, v)), o, lse, torch.from_numpy(do),
        **kw)
    want = _vjp(lambda a, b, c: jfa.mha_ref(a, b, c, **kw), (q, k, v), (do,))
    floor = 1e-2 * max(np.abs(w).max() for w in want)
    worst = 0.0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        err = float(np.abs(a.numpy() - b).max() / max(np.abs(b).max(),
                                                         floor))
        worst = max(worst, err)
        assert err <= 2e-2, err
    # the rounding is visible: the model is not the float32 backward
    exact = faref.flash_attention_bwd_ref(
        *map(torch.from_numpy, (q, k, v)), o, lse, torch.from_numpy(do),
        **kw)
    assert any(not torch.equal(a, b) for a, b in zip(got, exact))
    assert worst > 0.0


def _scan_inputs(rng, Bb, S, H, P, N):
    x = rng.standard_normal((Bb, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((Bb, S, H)))) * 0.1
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H))).astype(np.float32)
    B = (rng.standard_normal((Bb, S, N)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((Bb, S, N)) * 0.3).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("Bb,S,H,P,N,chunk", [(2, 37, 3, 8, 4, 16),
                                              (1, 64, 2, 16, 8, 32),
                                              (1, 20, 4, 4, 4, 128)])
def test_ssd_bwd_ref_matches_autograd_and_jax(Bb, S, H, P, N, chunk):
    rng = np.random.default_rng(2)
    ins = _scan_inputs(rng, Bb, S, H, P, N)
    gy = rng.standard_normal((Bb, S, H, P)).astype(np.float32)
    gs = rng.standard_normal((Bb, H, P, N)).astype(np.float32)
    got = sref.ssd_bwd_ref(*map(torch.from_numpy, ins), torch.from_numpy(gy),
                           torch.from_numpy(gs))
    port = _autograd(lambda *t: sref.ssd_chunked_ref(*t, chunk=chunk), ins,
                     (gy, gs))
    ref = _vjp(lambda *t: jssd.ssd_chunked_ref(*t, chunk=chunk), ins,
               (gy, gs))
    for name, a, b, c in zip("x dt A B C".split(), got, port, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, **TOL, err_msg=name)
        assert _rel(a.numpy(), c) <= 1e-4, (name, _rel(a.numpy(), c))


def test_ssd_bwd_ref_with_initial_state_and_no_state_gradient():
    rng = np.random.default_rng(3)
    ins = _scan_inputs(rng, 1, 11, 2, 4, 4)
    h0 = rng.standard_normal((1, 2, 4, 4)).astype(np.float32)
    gy = rng.standard_normal((1, 11, 2, 4)).astype(np.float32)
    got = sref.ssd_bwd_ref(*map(torch.from_numpy, ins), torch.from_numpy(gy),
                           None, torch.from_numpy(h0))
    want = _autograd(lambda *t: sref.ssd_sequential_ref(
        *t, initial_state=torch.from_numpy(h0))[0], ins, (gy,))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


# ---------------------------------------------------------------------------
# the autograd.Functions, with the launchers replaced by plain versions
# ---------------------------------------------------------------------------

def _contiguous(*ts):
    for t in ts:
        if t is not None:
            assert t.is_contiguous(), "the launchers take contiguous tensors"


@pytest.fixture
def plain_launchers(monkeypatch):
    """Route the wrappers' kernel branch to the plain versions."""
    monkeypatch.setattr(runtime, "use_kernel", lambda *ts: True)

    def rms_fwd(x, scale, eps=1e-6):
        _contiguous(x)
        return rref.rmsnorm_ref(x, scale, eps)

    def rms_bwd(x, scale, g, eps=1e-6):
        _contiguous(x, g)
        return rref.rmsnorm_bwd_ref(x, scale, g, eps)

    def fa_fwd(q, k, v, causal=True, window=0, softcap=0.0, with_lse=False):
        _contiguous(q, k, v)
        out, lse = faref.flash_attention_lse_ref(q, k, v, causal, window,
                                                 softcap)
        # the launcher writes a fresh contiguous output
        out, lse = out.contiguous(), lse.contiguous()
        return (out, lse) if with_lse else out

    def fa_bwd(q, k, v, o, lse, do, causal=True, window=0, softcap=0.0):
        _contiguous(q, k, v, o, lse, do)
        assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
        return faref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                             window, softcap)

    def scan_fwd(x, dt, A, B, C, initial_state=None):
        _contiguous(x, dt, A, B, C, initial_state)
        return sref.ssd_chunked_ref(x, dt, A, B, C,
                                    initial_state=initial_state)

    def scan_bwd(x, dt, A, B, C, gy, gstate=None, initial_state=None):
        _contiguous(x, dt, A, B, C, gy, gstate, initial_state)
        return sref.ssd_bwd_ref(x, dt, A, B, C, gy, gstate, initial_state)

    monkeypatch.setattr(rops._kernel, "rmsnorm_cuda", rms_fwd)
    monkeypatch.setattr(rops._kernel, "rmsnorm_bwd_cuda", rms_bwd)
    monkeypatch.setattr(faops._kernel, "flash_attention_cuda", fa_fwd)
    monkeypatch.setattr(faops._kernel, "flash_attention_bwd_cuda", fa_bwd)
    monkeypatch.setattr(sops._kernel, "ssm_scan_cuda", scan_fwd)
    monkeypatch.setattr(sops._kernel, "ssm_scan_bwd_cuda", scan_bwd)


def _grads(fn, leaves, couts):
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    for o in outs:
        assert o.grad_fn is not None
    total = sum((o * c).sum() for o, c in zip(outs, couts))
    return outs, torch.autograd.grad(total, leaves)


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


def test_rmsnorm_function(plain_launchers):
    rng = np.random.default_rng(4)
    x, s, g = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((3, 5, 32), (32,), (3, 5, 32)))
    f0, b0 = rops.rmsnorm.launches, rops.rmsnorm_bwd.launches
    outs, got = _grads(lambda a, b: rops.rmsnorm(a, b), _leaves(x, s),
                       [torch.from_numpy(g).transpose(0, 1).contiguous()
                        .transpose(0, 1)])
    assert type(outs[0].grad_fn).__name__ == "_RMSNormFnBackward"
    assert (rops.rmsnorm.launches, rops.rmsnorm_bwd.launches) == (f0 + 1,
                                                                  b0 + 1)
    want = _autograd(lambda a, b: rref.rmsnorm_ref(a, b), (x, s), (g,))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    # without a gradient to take, one launch and no Function
    with torch.no_grad():
        out = rops.rmsnorm(torch.from_numpy(x), torch.from_numpy(s))
    assert out.grad_fn is None and rops.rmsnorm.launches == f0 + 2


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window,softcap", FLASH_CASES)
def test_flash_function(plain_launchers, B, S, Hq, Hkv, hd, causal, window,
                        softcap):
    rng = np.random.default_rng(5)
    q, k, v, do = (rng.standard_normal(sh).astype(np.float32)
                   for sh in ((B, S, Hq, hd), (B, S, Hkv, hd),
                              (B, S, Hkv, hd), (B, S, Hq, hd)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    b0 = faops.flash_attention_bwd.launches
    outs, got = _grads(lambda a, b, c: faops.flash_attention(a, b, c, **kw),
                       _leaves(q, k, v), [torch.from_numpy(do)])
    assert type(outs[0].grad_fn).__name__ == "_FlashFnBackward"
    assert faops.flash_attention_bwd.launches == b0 + 1
    want = _autograd(lambda a, b, c: faref.flash_attention_ref(a, b, c, **kw),
                     (q, k, v), (do,))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, **TOL)


def test_scan_function_and_its_raise(plain_launchers):
    rng = np.random.default_rng(6)
    ins = _scan_inputs(rng, 2, 19, 3, 8, 4)
    gy = rng.standard_normal((2, 19, 3, 8)).astype(np.float32)
    gs = rng.standard_normal((2, 3, 8, 4)).astype(np.float32)
    b0 = sops.ssm_scan_bwd.launches
    outs, got = _grads(lambda *t: sops.ssm_scan(*t), _leaves(*ins),
                       [torch.from_numpy(gy), torch.from_numpy(gs)])
    assert type(outs[0].grad_fn).__name__ == "_ScanFnBackward"
    assert sops.ssm_scan_bwd.launches == b0 + 1
    want = _autograd(lambda *t: sref.ssd_chunked_ref(*t), ins, (gy, gs))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    # only y used: the final state's gradient arrives as zeros
    leaves = _leaves(*ins)
    y, _ = sops.ssm_scan(*leaves)
    only_y = torch.autograd.grad((y * torch.from_numpy(gy)).sum(), leaves)
    want = _autograd(lambda *t: sref.ssd_chunked_ref(*t)[0], ins, (gy,))
    for a, b in zip(only_y, want):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    h0 = torch.zeros(2, 3, 8, 4, requires_grad=True)
    with pytest.raises(NotImplementedError):
        sops.ssm_scan(*_leaves(*ins), initial_state=h0)


@pytest.mark.parametrize("name", ["tiny-cloud", "tiny-edge-c", "zamba2-4l"])
def test_model_gradients_through_the_functions(plain_launchers, monkeypatch,
                                               name):
    cfg = {"tiny-cloud": TINY_CLOUD.with_(dtype="float32", remat=True),
           "tiny-edge-c": TINY_EDGE_C.with_(dtype="float32"),
           "zamba2-4l": tc.SSM_CONFIGS["zamba2-4l"]}[name]
    params = transformer.init_params(cfg, 0, device="cpu", master=True)
    rng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 20)))
             for k in ("tokens", "targets")}
    counts = (rops.rmsnorm_bwd.launches, faops.flash_attention_bwd.launches,
              sops.ssm_scan_bwd.launches)
    loss, _, grads = steps.value_and_grad(cfg, params, batch)
    bwd = [a - b for a, b in zip((rops.rmsnorm_bwd.launches,
                                  faops.flash_attention_bwd.launches,
                                  sops.ssm_scan_bwd.launches), counts)]
    kinds = {k for k, _ in transformer.segments_of(cfg)}
    assert bwd[0] > 0
    assert (bwd[1] > 0) == bool(kinds & {"attn", "shared_attn"})
    assert (bwd[2] > 0) == ("mamba2" in kinds)
    monkeypatch.undo()                  # the plain path, autograd native
    want_loss, _, want = steps.value_and_grad(cfg, params, batch)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)
    for (path, a), b in zip(tree_lib.leaves_with_path(grads),
                            tree_lib.leaves(want)):
        if b is None:
            assert a is None, path
            continue
        torch.testing.assert_close(a, b, **TOL, msg=str(path))
