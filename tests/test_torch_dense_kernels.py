"""The dense-cache decode and the flash-attention wrappers of the port on CPU
tensors (their plain versions) against the JAX package's Pallas kernels in
interpret mode and its ref.py oracles, on the case families of
tests/test_kernels.py: window, softcap, non-causal, ragged lengths
(including 0), tails poisoned past each length, S no tile divides, head_dim
16/24/32/128 and q_per_kv 1/2/4/6. Also: a CPU tensor counts no kernel
launch, mixed devices are refused, and the CUDA wrappers check their
arguments before anything is built."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (thread count)
from repro.kernels.decode_attention import ops as jdops
from repro.kernels.decode_attention import ref as jdref
from repro.kernels.flash_attention import ops as jfops
from repro.kernels.flash_attention import ref as jfref
from repro_torch.kernels.decode_attention import kernel as dkernel
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention import ops as fops

TOL = dict(rtol=2e-5, atol=2e-5)       # tests/test_kernels.py, f32
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# (B, S, Hq, Hkv, hd): interpret mode is slow on the CPU, so S <= 128
FLASH_INTERPRET = [(2, 128, 4, 2, 32), (2, 64, 4, 1, 16), (1, 96, 6, 1, 24)]
FLASH_MASKS = [(True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0),
               (False, 0, 0.0), (False, 32, 30.0)]


@pytest.mark.parametrize("B,S,Hq,Hkv,hd", FLASH_INTERPRET)
@pytest.mark.parametrize("causal,window,softcap", FLASH_MASKS)
def test_flash_plain_vs_pallas(B, S, Hq, Hkv, hd, causal, window, softcap):
    rng = np.random.default_rng(S + hd)
    q, k, v = (_randn(rng, B, S, Hq, hd), _randn(rng, B, S, Hkv, hd),
               _randn(rng, B, S, Hkv, hd))
    before = fops.flash_attention.launches
    got = fops.flash_attention(*_t(q, k, v), causal=causal, window=window,
                               softcap=softcap)
    assert fops.flash_attention.launches == before
    want = jfops.flash_attention(*_j(q, k, v), causal=causal, window=window,
                                 softcap=softcap, block_q=32, block_kv=32,
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# S of 200 and 300 are no multiple of a tile; head_dim 128
@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [(1, 256, 8, 8, 64),
                                           (1, 200, 12, 2, 128),
                                           (2, 300, 6, 1, 24)])
@pytest.mark.parametrize("causal,window,softcap", FLASH_MASKS)
def test_flash_plain_vs_oracle(B, S, Hq, Hkv, hd, causal, window, softcap):
    rng = np.random.default_rng(S * hd)
    q, k, v = (_randn(rng, B, S, Hq, hd), _randn(rng, B, S, Hkv, hd),
               _randn(rng, B, S, Hkv, hd))
    got = fops.flash_attention(*_t(q, k, v), causal=causal, window=window,
                               softcap=softcap)
    want = jfref.mha_ref(*_j(q, k, v), causal=causal, window=window,
                         softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_plain_bf16_vs_oracle():
    rng = np.random.default_rng(5)
    q, k, v = (_randn(rng, 2, 64, 4, 32), _randn(rng, 2, 64, 2, 32),
               _randn(rng, 2, 64, 2, 32))
    got = fops.flash_attention(*[t.bfloat16() for t in _t(q, k, v)],
                               window=16)
    want = jfref.mha_ref(*[a.astype(jnp.bfloat16) for a in _j(q, k, v)],
                         window=16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

# (B, S, Hq, Hkv, hd): S = 100 overhangs the 64-row block
DECODE_CASES = [(2, 128, 4, 2, 32), (3, 100, 6, 1, 24), (2, 64, 16, 4, 128),
                (3, 96, 8, 8, 64)]


def _decode_inputs(rng, B, S, Hq, Hkv, hd):
    q = _randn(rng, B, 1, Hq, hd)
    k, v = _randn(rng, B, S, Hkv, hd), _randn(rng, B, S, Hkv, hd)
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    lens[0] = 0                       # a length-0 slot
    lens[-1] = S                      # a full cache
    return q, k, v, lens


@pytest.mark.parametrize("B,S,Hq,Hkv,hd", DECODE_CASES)
def test_decode_plain_vs_pallas(B, S, Hq, Hkv, hd):
    """Zeros at length 0, as the Pallas kernel's denom = 1 gives."""
    rng = np.random.default_rng(S + hd)
    q, k, v, lens = _decode_inputs(rng, B, S, Hq, Hkv, hd)
    before = dops.decode_attention.launches
    got = dops.decode_attention(*_t(q, k, v, lens))
    assert dops.decode_attention.launches == before
    want = jdops.decode_attention(*_j(q, k, v, lens), block_s=64,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got[0].numpy() == 0)


@pytest.mark.parametrize("B,S,Hq,Hkv,hd", DECODE_CASES + [(2, 300, 12, 2, 128)])
def test_decode_plain_vs_oracle(B, S, Hq, Hkv, hd):
    """The oracle at lengths >= 1 (at 0 it returns the mean of V)."""
    rng = np.random.default_rng(S * hd)
    q, k, v, lens = _decode_inputs(rng, B, S, Hq, Hkv, hd)
    got = dops.decode_attention(*_t(q, k, v, lens))
    want = jdref.decode_attention_ref(*_j(q, k, v, lens))
    np.testing.assert_allclose(got.numpy()[1:], np.asarray(want)[1:], **TOL)


def test_decode_poisoned_tails_carry_no_weight():
    """NaN and huge values past each length change nothing, as in
    tests/test_kernels.py::test_decode_attention_ragged_lengths."""
    rng = np.random.default_rng(3)
    q, k, v, lens = _decode_inputs(rng, 3, 128, 4, 4, 32)
    lens[:] = [40, 100, 7]
    clean = dops.decode_attention(*_t(q, k, v, lens))
    for b, n in enumerate(lens):
        k[b, n:] = np.nan if b % 2 else 99.0
        v[b, n:] = np.nan if b % 2 else -99.0
    got = dops.decode_attention(*_t(q, k, v, lens))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), clean.numpy(), atol=1e-6)


def test_decode_plain_bf16_vs_oracle():
    rng = np.random.default_rng(4)
    q, k, v, lens = _decode_inputs(rng, 2, 64, 8, 2, 32)
    got = dops.decode_attention(*[t.bfloat16() for t in _t(q, k, v)],
                                torch.from_numpy(lens))
    want = jdref.decode_attention_ref(
        *[a.astype(jnp.bfloat16) for a in _j(q, k, v)], jnp.asarray(lens))
    np.testing.assert_allclose(got.float().numpy()[1:],
                               np.asarray(want, np.float32)[1:], **BF16_TOL)


# ---------------------------------------------------------------------------
# routing and argument checks
# ---------------------------------------------------------------------------

def test_mixed_devices_are_refused():
    q = torch.zeros(1, 1, 2, 8)
    meta = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError):
        dops.decode_attention(q, meta, meta, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        fops.flash_attention(torch.zeros(1, 4, 2, 8), meta, meta)


@pytest.mark.parametrize("bad", ["two_tokens", "hd", "stride", "dtype"])
def test_decode_kernel_wrapper_checks_arguments(bad):
    """The CUDA wrapper raises on what the kernel does not take, before it
    loads or builds anything."""
    B, S, H, hd = 2, 16, 2, 32
    q = torch.zeros(B, 1, H, hd)
    k = torch.zeros(B, S, H, hd)
    lens = torch.ones(B, dtype=torch.int32)
    if bad == "two_tokens":
        q = torch.zeros(B, 2, H, hd)
    elif bad == "hd":
        q, k = torch.zeros(B, 1, H, 30), torch.zeros(B, S, H, 30)
    elif bad == "stride":
        k = torch.zeros(B, S, hd, H).transpose(2, 3)
    else:
        k = k.bfloat16()
    with pytest.raises(ValueError):
        dkernel.decode_attention_cuda(q, k, k, lens)


@pytest.mark.parametrize("bad", ["shape", "hd", "q_per_kv", "window"])
def test_flash_kernel_wrapper_checks_arguments(bad):
    q = torch.zeros(1, 8, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    kw = {}
    if bad == "shape":
        k = torch.zeros(1, 9, 2, 32)
    elif bad == "hd":
        q, k = torch.zeros(1, 8, 4, 30), torch.zeros(1, 8, 2, 30)
    elif bad == "q_per_kv":
        q, k = torch.zeros(1, 8, 65, 32), torch.zeros(1, 8, 1, 32)
    else:
        kw = dict(window=-1)
    with pytest.raises(ValueError):
        fkernel.flash_attention_cuda(q, k, k, **kw)


@pytest.mark.parametrize("B,Hkv,S", [(8, 8, 1024), (8, 2, 1024), (1, 1, 300),
                                     (64, 8, 17), (2, 2, 0), (1, 2, 512),
                                     (1, 8, 4096)])
def test_decode_split_covers_the_cache(B, Hkv, S):
    """Every cache row has a block, no block is empty, and the splits of
    one (slot, kv head) fit in one thread-block cluster."""
    from repro_torch.kernels.paged_decode_attention.kernel import MAX_SPLITS
    splits, per = dkernel.split_rows(B, Hkv, S, 132)
    assert per % dkernel.SPLIT_UNIT == 0 and 1 <= splits <= MAX_SPLITS
    assert splits * per >= S and (splits - 1) * per < max(S, 1)
