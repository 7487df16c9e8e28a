"""The port's CUDA kernels against their plain versions on the card. These
need an NVIDIA card and skip without one; on the card run

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py imports jax, which a machine
with only the port installed may lack.)
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as ddops
from repro_torch.kernels.decode_attention import ref as ddref
from repro_torch.kernels.flash_attention import ops as faops
from repro_torch.kernels.flash_attention import ref as faref
from repro_torch.kernels.paged_decode_attention import ops as dops
from repro_torch.kernels.paged_decode_attention import ref as dref
from repro_torch.kernels.paged_prefill_attention import ops as pops
from repro_torch.kernels.paged_prefill_attention import ref as pref
from repro_torch.kernels.rmsnorm import ops as rops
from repro_torch.kernels.rmsnorm import ref as rref
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.kernels.ssm_scan import ref as sref

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _table(lens, page, P):
    tbl = torch.full((len(lens), P), -1, dtype=torch.int32)
    nxt = 0
    for b, ln in enumerate(lens):
        live = -(-int(ln) // page)
        tbl[b, :live] = torch.arange(nxt, nxt + live, dtype=torch.int32)
        nxt += live
    return tbl.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,hd,page", [(8, 2, 32, 8), (4, 4, 24, 16),
                                            (12, 2, 128, 32)])
def test_decode_kernel_matches_plain(gen, dtype, Hq, Hkv, hd, page):
    B, P = 3, 5
    lens = [0, 2 * page + 3, page // 2]
    q = torch.randn(B, 1, Hq, hd, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(B * P, page, Hkv, hd, generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn_like(kp)
    tbl, ln = _table(lens, page, P), torch.tensor(lens, dtype=torch.int32,
                                                  device="cuda")
    before = dops.paged_decode_attention.launches
    got = dops.paged_decode_attention(q, kp, vp, tbl, ln)
    torch.cuda.synchronize()
    assert dops.paged_decode_attention.launches == before + 1
    torch.testing.assert_close(
        got.float(), dref.paged_decode_attention_ref(q, kp, vp, tbl,
                                                     ln).float(),
        **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,hd,page,C", [(8, 2, 32, 8, 16),
                                              (12, 2, 128, 32, 64),
                                              (12, 2, 80, 12, 40),
                                              (24, 4, 256, 64, 64),
                                              (72, 1, 32, 12, 37)])
def test_prefill_kernels_match_plain(gen, dtype, Hq, Hkv, hd, page, C):
    offs = torch.tensor([C, 0, 0], dtype=torch.int32)
    lens = torch.tensor([C, C // 2, 0], dtype=torch.int32)
    rows = _table((offs + lens).tolist(), page, -(-2 * C // page))
    kp = torch.randn(int(rows.max()) + 2, page, Hkv, hd, generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn_like(kp)
    q = torch.randn(3, C, Hq, hd, generator=gen, device="cuda").to(dtype)
    offs, lens = offs.cuda(), lens.cuda()
    got = pops.paged_prefill_attention_ragged(q, kp, vp, rows, offs, lens)
    want = pref.paged_prefill_attention_ragged_ref(q, kp, vp, rows, offs,
                                                   lens)
    one = pops.paged_prefill_attention(q[:1], kp, vp, rows[0], C, C)
    torch.cuda.synchronize()
    for r in range(2):
        n = int(lens[r])
        torch.testing.assert_close(got[r, :n].float(), want[r, :n].float(),
                                   **TOL[dtype])
    torch.testing.assert_close(one[0].float(), want[0].float(), **TOL[dtype])


def _poisoned_cache(gen, B, S, Hkv, hd, dtype, lens):
    """(k, v) caches with NaN at every position past each slot's length."""
    k = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dtype)
    past = (torch.arange(S, device="cuda")[None, :]
            >= lens[:, None])[:, :, None, None]
    return (k.masked_fill(past, float("nan")),
            v.masked_fill(past, float("nan")))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [
    (2, 128, 4, 2, 32), (3, 256, 8, 8, 64), (2, 64, 16, 4, 128),
    (3, 300, 12, 2, 128), (3, 200, 6, 1, 24)])
def test_dense_decode_kernel_matches_plain(gen, dtype, B, S, Hq, Hkv, hd):
    """Ragged lengths from 1 to S, NaN past each length, a slot of length 0
    (zeros), and S values no tile divides."""
    lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda")
    lens[0], lens[-1] = 0, S
    lens = lens.to(torch.int32)
    q = torch.randn(B, 1, Hq, hd, generator=gen, device="cuda").to(dtype)
    k, v = _poisoned_cache(gen, B, S, Hkv, hd, dtype, lens)
    before = ddops.decode_attention.launches
    got = ddops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert ddops.decode_attention.launches == before + 1
    assert torch.isfinite(got).all()
    assert torch.all(got[0] == 0), "a zero-length slot must give zeros"
    torch.testing.assert_close(
        got.float(), ddref.decode_attention_ref(q, k, v, lens).float(),
        **TOL[dtype])


@pytest.mark.cuda
def test_dense_decode_kernel_reads_a_cache_slice(gen):
    """The kernel reads a (B, S', Hkv, hd) slice of a larger cache through
    its strides, without a copy."""
    big_k = torch.randn(4, 96, 2, 32, generator=gen, device="cuda")
    big_v = torch.randn(4, 96, 2, 32, generator=gen, device="cuda")
    k, v = big_k[1:3, :64], big_v[1:3, 8:72]
    q = torch.randn(2, 1, 8, 32, generator=gen, device="cuda")
    lens = torch.tensor([64, 17], dtype=torch.int32, device="cuda")
    got = ddops.decode_attention(q, k, v, lens)
    want = ddref.decode_attention_ref(q, k.contiguous(), v.contiguous(), lens)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_live_view(gen, dtype):
    """The engine's read: a view of a cache's first live rows, where a
    length past the view (an inactive slot) reads all of it."""
    lens = torch.tensor([0, 5, 300, 301, 700], dtype=torch.int32,
                        device="cuda")
    q = torch.randn(5, 1, 32, 128, generator=gen, device="cuda").to(dtype)
    k, v = _poisoned_cache(gen, 5, 1024, 8, 128, dtype, lens)
    k, v = k[:, :301], v[:, :301]
    got = ddops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.all(got[0] == 0)
    torch.testing.assert_close(
        got.float(), ddref.decode_attention_ref(q, k, v, lens).float(),
        **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [
    (2, 128, 4, 2, 32), (1, 256, 8, 8, 64), (2, 64, 4, 1, 16),
    (1, 512, 2, 2, 128), (1, 200, 12, 2, 128), (2, 300, 6, 1, 24)])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0), (False, 0, 0.0),
    (False, 64, 30.0)])
def test_flash_kernel_matches_plain(gen, dtype, B, S, Hq, Hkv, hd, causal,
                                    window, softcap):
    q = torch.randn(B, S, Hq, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dtype)
    before = faops.flash_attention.launches
    got = faops.flash_attention(q, k, v, causal=causal, window=window,
                                softcap=softcap)
    torch.cuda.synchronize()
    assert faops.flash_attention.launches == before + 1
    want = faref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# (causal, window, softcap) of the tensor-core flash kernel's cases
FLASH_MASKS = [(True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0),
               (False, 0, 0.0), (False, 64, 30.0), (True, 64, 30.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,hd", [(8, 8, 64), (32, 8, 128),
                                       (12, 2, 128), (32, 2, 256),
                                       (72, 1, 80), (32, 32, 80)])
@pytest.mark.parametrize("S", [1, 37, 200, 1000])
@pytest.mark.parametrize("causal,window,softcap", FLASH_MASKS)
def test_flash_tensor_core_kernel_matches_plain(gen, Hq, Hkv, hd, S, causal,
                                                window, softcap):
    """The bf16 (wgmma) flash kernel at q_per_kv 1 / 4 / 6 / 16 / 72 (a GQA
    group split over blocks), head_dim 64 / 80 / 128 / 256, S 1 to 1000,
    and every launch shape (128-row blocks; 64 rows with two key groups
    and with one), against its plain version at rtol = atol = 2e-2."""
    B = 2 if S == 37 else 1
    dt = torch.bfloat16
    q = torch.randn(B, S, Hq, hd, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dt)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = faops.flash_attention.launches
    got = faops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert faops.flash_attention.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got.float(), faref.flash_attention_ref(q, k, v, **kw).float(),
        **TOL[dt])


def _quant_pool(gen, n_pages, page, Hkv, hd, kv_dtype):
    """A random pool quantized per (page, kv head), with its scales."""
    from repro_torch.models import paged_cache as pc
    f = torch.randn(n_pages, page, Hkv, hd, generator=gen, device="cuda")
    scale = pc.quant_scale(f.abs().amax(dim=(1, 3)), kv_dtype)
    return pc._quantize(f, scale, kv_dtype), scale


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,hd,page", [(8, 2, 32, 8), (4, 4, 24, 16),
                                            (12, 2, 128, 32), (6, 1, 16, 8)])
def test_quant_decode_kernel_matches_plain(gen, kv_dtype, dtype, Hq, Hkv,
                                           hd, page):
    B, P = 3, 5
    lens = [0, 2 * page + 3, page // 2]
    q = torch.randn(B, 1, Hq, hd, generator=gen, device="cuda").to(dtype)
    kp, ks = _quant_pool(gen, B * P, page, Hkv, hd, kv_dtype)
    vp, vs = _quant_pool(gen, B * P, page, Hkv, hd, kv_dtype)
    tbl, ln = _table(lens, page, P), torch.tensor(lens, dtype=torch.int32,
                                                  device="cuda")
    before = dops.paged_decode_attention_quant.launches
    got = dops.paged_decode_attention_quant(q, kp, vp, ks, vs, tbl, ln)
    torch.cuda.synchronize()
    assert dops.paged_decode_attention_quant.launches == before + 1
    assert got.dtype == dtype and torch.all(got[0] == 0)
    torch.testing.assert_close(
        got.float(), dref.paged_decode_attention_quant_ref(
            q, kp, vp, ks, vs, tbl, ln).float(), **TOL[dtype])


def _poison_past(pool, tbl, lens, page):
    """NaN (bf16, fp8) or 127 (int8) at every position of each slot's last
    mapped page past its length."""
    raw = pool.view(torch.uint8)
    for b, n in enumerate(lens):
        if n % page:
            pg = int(tbl[b, n // page])
            if pool.dtype == torch.bfloat16:
                pool[pg, n % page:] = float("nan")
            else:
                raw[pg, n % page:] = 0x7F


_DECODE_SHAPES = [(3, 4, 4, 24, 8, 6), (2, 4, 2, 16, 12, 9),
                  (66, 32, 8, 128, 32, 3), (4, 12, 2, 80, 64, 3),
                  (2, 16, 1, 256, 16, 8), (2, 24, 1, 36, 12, 10),
                  (1, 32, 8, 128, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,B,Hq,Hkv,hd,page,P", [
    (kv, *shape) for kv in ("bf16", "int8", "fp8") for shape in _DECODE_SHAPES
    if kv == "bf16" or shape[3] % 8 == 0])     # int8 / fp8: hd of 8s
def test_tensor_core_decode_kernel_matches_plain(gen, kv_dtype, B, Hq, Hkv,
                                                 hd, page, P):
    """A bfloat16 query on the tensor-core decode kernel over bf16, int8 and
    fp8 pools: q_per_kv 1 to 24 (two 16-head row tiles), head_dim 16 to 256
    (36: 8-byte copies), pages of 8, 12, 64 and 32, splits of 1 (66 slots
    fill the card) up to the cluster cap, one slot of 4,096 keys; a
    zero-length slot, -1 tail pages, NaN or 127 past each length."""
    bf16 = torch.bfloat16
    lens = ([P * page] if B == 1 else
            [0] + [(7 * b) % (P * page) + 1 for b in range(1, B)])
    tbl = _table(lens, page, P)
    n_pages = max(int(tbl.max()) + 2, 2)
    q = torch.randn(B, 1, Hq, hd, generator=gen, device="cuda").to(bf16)
    if kv_dtype == "bf16":
        kp = torch.randn(n_pages, page, Hkv, hd, generator=gen,
                         device="cuda").to(bf16)
        vp = torch.randn_like(kp)
        kv = (kp, vp)
        fn, plain = dops.paged_decode_attention, dref.paged_decode_attention_ref
    else:
        kp, ks = _quant_pool(gen, n_pages, page, Hkv, hd, kv_dtype)
        vp, vs = _quant_pool(gen, n_pages, page, Hkv, hd, kv_dtype)
        kv = (kp, vp, ks, vs)
        fn = dops.paged_decode_attention_quant
        plain = dref.paged_decode_attention_quant_ref
    for pool in kv[:2]:
        _poison_past(pool, tbl.cpu(), lens, page)
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = fn.launches
    got = fn(q, *kv, tbl, ln)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.isfinite(got).all()
    if B > 1:
        assert torch.all(got[0] == 0), "a zero-length slot gives zeros"
    torch.testing.assert_close(got.float(), plain(q, *kv, tbl, ln).float(),
                               **TOL[bf16])


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_tensor_core_decode_kernel_cow_pages(gen, kv_dtype):
    """Slots that share prefix pages (a COW fan-out), pages of 12."""
    bf16 = torch.bfloat16
    q = torch.randn(2, 1, 12, 32, generator=gen, device="cuda").to(bf16)
    if kv_dtype == "bf16":
        kp = torch.randn(12, 12, 2, 32, generator=gen, device="cuda").to(bf16)
        kv = (kp, torch.randn_like(kp))
        fn, plain = dops.paged_decode_attention, dref.paged_decode_attention_ref
    else:
        kp, ks = _quant_pool(gen, 12, 12, 2, 32, kv_dtype)
        vp, vs = _quant_pool(gen, 12, 12, 2, 32, kv_dtype)
        kv = (kp, vp, ks, vs)
        fn = dops.paged_decode_attention_quant
        plain = dref.paged_decode_attention_quant_ref
    tbl = torch.tensor([[0, 1, 2, -1], [0, 1, 3, 4]], dtype=torch.int32,
                       device="cuda")
    ln = torch.tensor([30, 45], dtype=torch.int32, device="cuda")
    got = fn(q, *kv, tbl, ln)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), plain(q, *kv, tbl, ln).float(),
                               **TOL[bf16])


@pytest.mark.cuda
@pytest.mark.parametrize("S,view", [(400, True), (4096, False)])
def test_tensor_core_dense_decode_kernel(gen, S, view):
    """The bf16 dense cache on the tensor-core decode kernel: a slice of a
    larger cache (row offset 3, S = 200, no multiple of a tile) with NaN
    past each length and a zero-length slot, and 4,096 rows of one slot."""
    bf16 = torch.bfloat16
    B = 4 if view else 1
    lens = (torch.tensor([0, 1, 77, 200]) if view
            else torch.tensor([S])).to(torch.int32).cuda()
    k, v = _poisoned_cache(gen, B, S, 8, 128, bf16, lens + (3 if view else 0))
    if view:
        k, v = k[:, 3:203], v[:, 3:203]
    q = torch.randn(B, 1, 32, 128, generator=gen, device="cuda").to(bf16)
    got = ddops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got.float(), ddref.decode_attention_ref(q, k, v, lens).float(),
        **TOL[bf16])


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,hd,page,C", [(8, 2, 32, 8, 16),
                                              (12, 2, 128, 32, 64),
                                              (12, 2, 80, 12, 40),
                                              (24, 4, 256, 64, 64),
                                              (72, 1, 32, 12, 37)])
def test_quant_prefill_kernels_match_plain(gen, kv_dtype, dtype, Hq, Hkv, hd,
                                           page, C):
    offs = torch.tensor([C, 3, 0], dtype=torch.int32)
    lens = torch.tensor([C, C // 2, 0], dtype=torch.int32)
    rows = _table((offs + lens).tolist(), page, -(-2 * C // page))
    kp, ks = _quant_pool(gen, int(rows.max()) + 2, page, Hkv, hd, kv_dtype)
    vp, vs = _quant_pool(gen, int(rows.max()) + 2, page, Hkv, hd, kv_dtype)
    q = torch.randn(3, C, Hq, hd, generator=gen, device="cuda").to(dtype)
    offs, lens = offs.cuda(), lens.cuda()
    b_ragged = pops.paged_prefill_attention_ragged_quant.launches
    b_one = pops.paged_prefill_attention_quant.launches
    got = pops.paged_prefill_attention_ragged_quant(q, kp, vp, ks, vs, rows,
                                                    offs, lens)
    want = pref.paged_prefill_attention_ragged_quant_ref(q, kp, vp, ks, vs,
                                                         rows, offs, lens)
    one = pops.paged_prefill_attention_quant(q[:1], kp, vp, ks, vs, rows[0],
                                             C, C)
    torch.cuda.synchronize()
    assert pops.paged_prefill_attention_ragged_quant.launches == b_ragged + 1
    assert pops.paged_prefill_attention_quant.launches == b_one + 1
    for r in range(2):
        n = int(lens[r])
        torch.testing.assert_close(got[r, :n].float(), want[r, :n].float(),
                                   **TOL[dtype])
    torch.testing.assert_close(one[0].float(), want[0].float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv", [(torch.float32, torch.bfloat16),
                                      (torch.bfloat16, torch.float32)])
def test_float_kernels_take_another_pool_dtype(gen, dtype, kv):
    B, P, Hq, Hkv, hd, page = 3, 5, 8, 2, 32, 8
    lens = [0, 2 * page + 3, page // 2]
    q = torch.randn(B, 1, Hq, hd, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(B * P, page, Hkv, hd, generator=gen,
                     device="cuda").to(kv)
    vp = torch.randn_like(kp)
    tbl, ln = _table(lens, page, P), torch.tensor(lens, dtype=torch.int32,
                                                  device="cuda")
    got = dops.paged_decode_attention(q, kp, vp, tbl, ln)
    assert got.dtype == dtype
    torch.testing.assert_close(
        got.float(), dref.paged_decode_attention_ref(q, kp, vp, tbl,
                                                     ln).float(),
        **TOL[dtype])
    offs = torch.tensor([3, 0, 0], dtype=torch.int32)
    ln = torch.tensor([16, 8, 0], dtype=torch.int32)
    tbl = _table((offs + ln).tolist(), page, P)     # every row's pages
    offs, ln = offs.cuda(), ln.cuda()
    qc = torch.randn(B, 16, Hq, hd, generator=gen, device="cuda").to(dtype)
    got = pops.paged_prefill_attention_ragged(qc, kp, vp, tbl, offs, ln)
    want = pref.paged_prefill_attention_ragged_ref(qc, kp, vp, tbl, offs, ln)
    torch.cuda.synchronize()
    for r in range(2):
        n = int(ln[r])
        torch.testing.assert_close(got[r, :n].float(), want[r, :n].float(),
                                   **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quant_tiny_engine_card_vs_cpu(gen, kv_dtype):
    """An int8 / fp8 TINY engine on the card against the same on the CPU:
    greedy tokens equal (both read the same quantized numbers; a part at a
    near-tie ends the comparison of that request) and logprobs within 1e-2
    (one rounding flip in a requantized page is a whole quantization step).
    """
    from repro_torch.models import transformer
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.engine import InferenceEngine
    tiny = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                       max_seq_len=512, dtype="float32", remat=False,
                       kv_dtype=kv_dtype, prefill_chunk=16)
    prompts = [[65 + i for i in range(43)], [70, 71], [80] * 40]
    params = transformer.init_params(tiny, seed=0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else {
            k: _to(v, "cuda") for k, v in params.items()}
        out[dev] = InferenceEngine(tiny, p, max_batch=3, max_len=128,
                                   page_size=16, device=dev).generate(
            prompts, max_new=12)
    parted = 0
    for (tg, lg), (tc, lc) in zip(out["cuda"], out["cpu"]):
        n = next((t for t, (a, b) in enumerate(zip(tg, tc)) if a != b),
                 min(len(tg), len(tc)))
        parted += n < min(len(tg), len(tc))
        torch.testing.assert_close(torch.tensor(lg[:n]), torch.tensor(lc[:n]),
                                   rtol=0, atol=1e-2)
    assert parted <= 1, "greedy tokens part on more than one request"


@pytest.mark.cuda
@pytest.mark.parametrize("Bb,S,H,P,N,chunk,initial,strong", [
    (2, 64, 3, 8, 16, 16, False, False), (1, 128, 2, 16, 32, 32, False, False),
    (2, 96, 1, 4, 8, 32, False, False), (1, 37, 4, 64, 16, 64, False, False),
    (1, 1000, 4, 64, 16, 64, False, False),
    (1, 1024, 80, 64, 64, 256, False, False),
    (2, 100, 3, 64, 64, 256, True, False),
    (2, 1, 3, 16, 32, 64, False, False), (2, 63, 3, 16, 32, 64, False, False),
    (2, 65, 3, 16, 32, 64, False, False),
    (2, 129, 3, 16, 32, 64, False, False),
    (2, 300, 3, 4, 8, 64, False, False), (2, 300, 4, 16, 16, 64, True, False),
    (1, 512, 4, 32, 32, 64, True, True),
    (4, 256, 80, 64, 64, 256, True, False),
    (1, 1500, 8, 64, 64, 64, True, False)])
def test_ssm_scan_kernel_matches_plain(gen, Bb, S, H, P, N, chunk, initial,
                                       strong):
    """The SSD kernel against its plain chunked version at rtol = atol =
    1e-4 (tests/test_kernels.py's tolerance for the TPU kernel): the JAX
    test's cases, ragged S, TINY_EDGE_C's and zamba2's heads, an initial
    state; then the edges of the cluster split: S of 1, 63, 65 and 129, P 4
    with N 8, an initial state crossing ranks, strong decays (A down to
    -80, dt up to 1; the plain version at the kernel's 64-row chunks), a
    batch that fills the card (one rank, two super-chunks) and S of 1,500
    (eight ranks of three chunks)."""
    x = torch.randn(Bb, S, H, P, generator=gen, device="cuda")
    if strong:
        dt = torch.rand(Bb, S, H, generator=gen, device="cuda")
        A = -(1 + 79 * torch.rand(H, generator=gen, device="cuda"))
    else:
        dt = torch.nn.functional.softplus(
            torch.randn(Bb, S, H, generator=gen, device="cuda")) * 0.1
        A = -torch.exp(torch.randn(H, generator=gen, device="cuda"))
    B = torch.randn(Bb, S, N, generator=gen, device="cuda") * 0.3
    C = torch.randn(Bb, S, N, generator=gen, device="cuda") * 0.3
    h0 = (torch.randn(Bb, H, P, N, generator=gen, device="cuda")
          if initial else None)
    before = sops.ssm_scan.launches
    y, h = sops.ssm_scan(x, dt, A, B, C, chunk=chunk, initial_state=h0)
    torch.cuda.synchronize()
    assert sops.ssm_scan.launches == before + 1
    yr, hr = sref.ssd_chunked_ref(x, dt, A, B, C, chunk=chunk,
                                  initial_state=h0)
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, hr, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D", [(3, 96), (1000, 128), (37, 1536),
                                 (64, 2560), (5, 4096), (129, 5120)])
def test_rmsnorm_kernel_matches_plain(gen, dtype, R, D):
    x = torch.randn(R, D, generator=gen, device="cuda").to(dtype)
    scale = torch.randn(D, generator=gen, device="cuda")
    before = rops.rmsnorm.launches
    got = rops.rmsnorm(x, scale, 1e-6)
    torch.cuda.synchronize()
    assert rops.rmsnorm.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(),
                               rref.rmsnorm_ref(x, scale, 1e-6).float(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 8, 256, 1027])
@pytest.mark.parametrize("D", [128, 1536, 2560, 4096, 5120])
def test_rmsnorm_kernel_at_serving_widths(gen, dtype, R, D):
    """The served widths (q/k-norm 128, qwen2-1.5b 1536, zamba2 2560 and
    its gated norm 5120, qwen3-8b 4096) at decode, q/k-norm and prefill
    row counts, and row counts no block divides."""
    x = torch.randn(R, D, generator=gen, device="cuda").to(dtype)
    scale = torch.randn(D, generator=gen, device="cuda")
    got = rops.rmsnorm(x, scale, 1e-6)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               rref.rmsnorm_ref(x, scale, 1e-6).float(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_monolithic_prefill_card_vs_cpu(gen, backend):
    """Monolithic prefill of right-padded prompts (lengths 5 / 17 / 32 in S
    32) at qwen3-8b's heads (32 over 8, head_dim 128, qk-norm), float32:
    on the card through the flash and RMSNorm kernels, on the CPU through
    the plain masked attention; logits and the K/V below each length agree
    within rtol 1e-4, atol 1e-5 (the card sums in another order)."""
    from repro_torch.models import transformer
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="tiny-q3", family="dense", n_layers=2,
                      d_model=256, n_heads=32, n_kv_heads=8, head_dim=128,
                      qk_norm=True, d_ff=256, vocab_size=128,
                      max_seq_len=512, dtype="float32", remat=False)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (3, 32),
                         generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([5, 17, 32], dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _to(params, "cuda")
        t, ln = toks.to(dev), lens.to(dev)
        if backend == "dense":
            cache = transformer.init_cache(cfg, 3, 40, device=dev)
            logits, cache = transformer.prefill(cfg, p, t, cache, ln)
            kv = [torch.stack([seg["k"], seg["v"]]).cpu()
                  for seg in cache["segments"]]
        else:
            cache = transformer.init_paged_cache(cfg, 3, 12, 8, 4,
                                                 device=dev)
            cache["block_table"].copy_(torch.arange(
                12, dtype=torch.int32, device=dev).reshape(3, 4))
            logits = torch.cat([transformer.prefill_paged(
                cfg, p, t[b:b + 1], cache, b, int(lens[b]))[0]
                for b in range(3)])
            kv = [torch.stack([seg["k_pages"], seg["v_pages"]])[:, :, :-1]
                  .cpu() for seg in cache["segments"]]
        out[dev] = (logits.cpu(), kv)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-5)
    below = (torch.arange(40)[None, :] < lens[:, None].long())
    for got, want in zip(out["cuda"][1], out["cpu"][1]):
        if backend == "dense":
            # (K/V, layers, B, S, Hkv, hd): rows below each length
            got, want = got[:, :, below], want[:, :, below]
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_ssm_tiny_engines_card_vs_cpu(gen, backend):
    """TINY_EDGE_C and zamba2 cut to 4 layers (float32) on the card against
    the CPU: greedy tokens equal, logprobs within rtol 1e-4, atol 1e-5 (the
    SSD kernel sums in another order than the plain scan), and the
    prefills went through the SSD kernel."""
    from repro_torch.configs.pice_cloud_edge import TINY_EDGE_C
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.serving.engine import InferenceEngine
    prompts = [[65 + i for i in range(43)], [70, 71], [80] * 32]
    for cfg in (TINY_EDGE_C.with_(dtype="float32"),
                get_config("zamba2-2.7b").reduced().with_(
                    n_layers=4, dtype="float32", remat=False)):
        params = transformer.init_params(cfg, seed=0, device="cpu")
        out = {}
        before = sops.ssm_scan.launches
        for dev in ("cpu", "cuda"):
            p = params if dev == "cpu" else _to(params, "cuda")
            out[dev] = InferenceEngine(cfg, p, max_batch=3, max_len=128,
                                       page_size=16, kv_backend=backend,
                                       device=dev).generate(prompts,
                                                            max_new=12)
        assert sops.ssm_scan.launches > before
        for (tg, lg), (tc, lc) in zip(out["cuda"], out["cpu"]):
            assert tg == tc
            torch.testing.assert_close(torch.tensor(lg), torch.tensor(lc),
                                       rtol=1e-4, atol=1e-5)


def _xlstm():
    """xlstm-1.3b cut to 4 layers (sLSTM, mLSTM, sLSTM, mLSTM), chunks of
    16, float32: the CPU tests' XLSTM."""
    from repro_torch.configs.registry import get_config
    return get_config("xlstm-1.3b").reduced().with_(
        n_layers=4, slstm_at=(0, 2), ssm_chunk=16, dtype="float32",
        remat=False)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_xlstm_tiny_engines_card_vs_cpu(gen, backend):
    """The 4-layer xLSTM stack (float32) on the card against the CPU:
    greedy tokens equal, logprobs within rtol 1e-4, atol 1e-5, every norm
    through the RMSNorm kernel (a 37-token prompt cuts its mLSTM chunks
    16 + 16 + 5), and a fan-out's late forks equal to its early ones."""
    from repro_torch.models import transformer
    from repro_torch.serving.engine import InferenceEngine
    cfg = _xlstm()
    prompts = [[65 + i for i in range(37)], [70, 71], [80] * 32]
    params = transformer.init_params(cfg, seed=0, device="cpu")
    out, fan = {}, {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _to(params, "cuda")
        eng = InferenceEngine(cfg, p, max_batch=3, max_len=128,
                              page_size=16, kv_backend=backend, device=dev)
        before = rops.rmsnorm.launches
        out[dev] = eng.generate(prompts, max_new=12)
        if dev == "cuda":
            assert rops.rmsnorm.launches > before
        if backend == "paged":
            fan[dev] = eng.generate_fanout([(7 * i) % 200 + 1
                                            for i in range(32)],
                                           [[7]] * 4, max_new=8)
    if backend == "paged":
        assert all(f == fan["cuda"][0] for f in fan["cuda"])
        out = {d: out[d] + fan[d] for d in out}
    for (tg, lg), (tc, lc) in zip(out["cuda"], out["cpu"]):
        assert tg == tc
        torch.testing.assert_close(torch.tensor(lg), torch.tensor(lc),
                                   rtol=1e-4, atol=1e-5)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _warm_pair(cfg, sampler=None, **kw):
    """A cold and a warmed paged engine on the card over the same weight
    tensors (TINY-sized, page 16, max_len 128)."""
    from repro_torch.models import transformer
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.sampler import SamplerConfig
    params = _to(transformer.init_params(cfg, seed=0, device="cpu"), "cuda")

    def make():
        return InferenceEngine(cfg, params, max_batch=3, max_len=128,
                               page_size=16, device="cuda",
                               sampler=sampler or SamplerConfig(), seed=5,
                               **kw)
    cold, warm = make(), make()
    assert warm.warmup(prompt_lens=(64,)) > 0
    return cold, warm


def _counted(fn):
    from repro_torch import kernels
    wrappers = kernels.wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches for name, w in wrappers.items()}


def _tiny(kv_dtype="", chunk=16):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
                       max_seq_len=512, dtype="float32", remat=False,
                       kv_dtype=kv_dtype, prefill_chunk=chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["float32", "int8", "tiny-edge-c",
                                   "xlstm"])
@pytest.mark.parametrize("sampled", [False, True])
def test_warmed_engine_equals_cold_on_card(gen, which, sampled):
    """A warmed paged engine replays one captured graph for every decode
    step (no eager decode dispatch) and gives the cold engine's tokens,
    logprobs and launch counts (float32 and int8 pools, the Mamba2 stack
    TINY_EDGE_C, the 4-layer xLSTM stack); sampled runs from the same seed
    draw the same tokens."""
    from repro_torch.configs.pice_cloud_edge import TINY_EDGE_C
    from repro_torch.serving.sampler import SamplerConfig
    cfg = {"float32": _tiny(), "int8": _tiny("int8"),
           "tiny-edge-c": TINY_EDGE_C.with_(dtype="float32"),
           "xlstm": _xlstm()}[which]
    sampler = SamplerConfig(temperature=0.8, top_k=16) if sampled else None
    cold, warm = _warm_pair(cfg, sampler)
    assert warm._graphs, "warmup captured no graph on the card"
    prompts = [[65 + i for i in range(43)], [70, 71], [80] * 32]
    want, n_cold = _counted(lambda: cold.generate(prompts, max_new=12))
    eager = []
    decode_sample = warm._decode_sample
    warm._decode_sample = lambda *a, **kw: (eager.append(1),
                                            decode_sample(*a, **kw))[1]
    try:
        got, n_warm = _counted(lambda: warm.generate(prompts, max_new=12))
    finally:
        # the wrapper closes a reference cycle through the engine, whose
        # graphs the cyclic collector could then free during a later
        # test's capture, which a capture does not allow
        del warm._decode_sample
    assert not eager, "a decode step ran eagerly on the warmed engine"
    assert n_warm == n_cold
    decode = "paged_decode_attention_quant" if which == "int8" \
        else "paged_decode_attention"
    layers = sum(k in ("attn", "shared_attn") for k in cfg.block_pattern())
    assert warm.graph_replays > 0
    assert n_warm[decode] == warm.graph_replays * layers, \
        "a decode step ran outside the captured graphs"
    for (tg, lg), (tc, lc) in zip(got, want):
        assert tg == tc
        torch.testing.assert_close(torch.tensor(lg), torch.tensor(lc),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["float32", "bfloat16", "int8"])
def test_replayed_ingest_equals_eager_at_every_bucket(gen, which):
    """A warmed 6-slot chunked engine captures the batched ragged ingest at
    row buckets 1, 2, 4 and 6 and replays one for every ingest: each replay
    gives the eager call's logits rows, K/V pages (and scales) and cached
    lengths bit for bit at the rows' bucketed live width, over sentinel
    padding rows, partial chunks, later chunks and fork suffixes (float32,
    bf16, and an int8 pool under bf16), credits each wrapper the eager
    call's launches (the ragged prefill kernel once a layer), and the
    engine's `ingest_replays` counts every ingest."""
    from _ingest_graphs import IngestSpy, drive
    from repro_torch.models import transformer
    from repro_torch.serving.engine import InferenceEngine
    cfg = {"float32": _tiny(), "bfloat16": _tiny().with_(dtype="bfloat16"),
           "int8": _tiny("int8").with_(dtype="bfloat16")}[which]
    params = _to(transformer.init_params(cfg, seed=0, device="cpu"), "cuda")
    kw = dict(max_batch=6, max_len=128, page_size=16, device="cuda")
    warm = InferenceEngine(cfg, params, **kw)
    assert warm.warmup(prompt_lens=(64,)) > 0
    assert sorted(warm._ingest_graphs) == [1, 2, 4, 6]
    replayed = []
    run_ingest = warm._run_ingest

    def counted():
        rows, graph = run_ingest()
        if rows:
            replayed.append(graph)
        return rows, graph
    warm._run_ingest = counted
    try:
        with IngestSpy(warm, exact=True) as spy:
            got = drive(warm)
    finally:
        del warm._run_ingest
    spy.covered([1, 2, 4, 6], chunk=16, page=16)
    assert all(replayed), "an ingest ran eagerly on the warmed engine"
    assert warm.ingest_replays == len(spy.calls) == len(replayed)
    ragged = ("paged_prefill_attention_ragged_quant" if which == "int8"
              else "paged_prefill_attention_ragged")
    assert all(c["launches"].get(ragged) == cfg.n_layers
               for c in spy.calls)
    want = drive(InferenceEngine(cfg, params, **kw))
    for (tg, lg), (tc, lc) in zip(got, want):
        assert tg == tc
        torch.testing.assert_close(torch.tensor(lg), torch.tensor(lc),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_moved_leaf_after_capture_raises(gen):
    """A cache leaf put in other storage after the capture makes the next
    decode step raise instead of replaying over the old pointers."""
    _, warm = _warm_pair(_tiny())
    seg = warm.cache["segments"][0]
    seg["k_pages"] = seg["k_pages"].clone()
    with pytest.raises(RuntimeError, match="moved"):
        warm.generate([[1, 2, 3]], max_new=4)


# ---------------------------------------------------------------------------
# Backward kernels against torch.autograd through the plain versions
# ---------------------------------------------------------------------------

# largest difference over the reference gradient's largest magnitude: f32
# within 2e-5, bf16 within 2e-2. A gradient that is zero in exact
# arithmetic (dA of a one-token scan from a zero state) is measured against
# 1 % of the largest magnitude among the call's gradients instead.
GRAD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _rel(got, want, floor=1e-30):
    scale = want.float().abs().max().clamp_min(floor)
    return float((got.float() - want.float()).abs().max() / scale)


def _floor(grads):
    return 1e-2 * max(float(g.float().abs().max()) for g in grads)


@pytest.fixture
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _plain_grads(fn, inputs, grads_out):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o.float() * g.float()).sum() for o, g in zip(outs, grads_out))
    return torch.autograd.grad(total, leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D", [(1, 128), (37, 96), (1027, 1536),
                                 (8, 4096), (300, 8192)])
def test_rmsnorm_bwd_kernel_matches_autograd(gen, no_tf32, dtype, R, D):
    x = torch.randn(R, D, generator=gen, device="cuda").to(dtype)
    scale = torch.randn(D, generator=gen, device="cuda")
    g = torch.randn(R, D, generator=gen, device="cuda").to(dtype)
    want = _plain_grads(lambda a, s: rref.rmsnorm_ref(a, s, 1e-6), (x, scale),
                        (g,))
    before = rops.rmsnorm_bwd.launches
    got = rops.rmsnorm_bwd(x, scale, g, 1e-6)
    again = rops.rmsnorm_bwd(x, scale, g, 1e-6)
    assert rops.rmsnorm_bwd.launches == before + 2
    for a, b, c in zip(got, want, again):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel(a, b) <= GRAD_TOL[dtype], _rel(a, b)
        assert torch.equal(a, c)            # the same bits on every run
    # through the autograd.Function of the forward wrapper
    xl = x.clone().requires_grad_(True)
    sl = scale.clone().requires_grad_(True)
    out = rops.rmsnorm(xl, sl, 1e-6)
    assert type(out.grad_fn).__name__.startswith("_RMSNormFn")
    dx, ds = torch.autograd.grad((out.float() * g.float()).sum(), (xl, sl))
    assert _rel(dx, want[0]) <= GRAD_TOL[dtype]
    assert _rel(ds, want[1]) <= GRAD_TOL[dtype]


FLASH_BWD_MASKS = [(True, 0, 0.0), (True, 64, 0.0), (True, 0, 30.0),
                   (False, 0, 0.0), (True, 16, 5.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [(2, 37, 4, 4, 32),
                                           (2, 200, 12, 2, 128),
                                           (1, 129, 6, 1, 80),
                                           (1, 70, 2, 2, 256)])
@pytest.mark.parametrize("mask", FLASH_BWD_MASKS)
def test_flash_bwd_kernel_matches_autograd(gen, no_tf32, dtype, B, S, Hq,
                                           Hkv, hd, mask):
    causal, window, softcap = mask
    q = torch.randn(B, S, Hq, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dtype)
    do = torch.randn(B, S, Hq, hd, generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = _plain_grads(lambda a, b_, c: faref.flash_attention_ref(a, b_, c,
                                                                   **kw),
                        (q, k, v), (do,))
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (q, k, v))
    f0, b0 = faops.flash_attention.launches, faops.flash_attention_bwd.launches
    out = faops.flash_attention(ql, kl, vl, **kw)
    assert type(out.grad_fn).__name__.startswith("_FlashFn")
    got = torch.autograd.grad(out, (ql, kl, vl), do)
    assert faops.flash_attention.launches == f0 + 1
    assert faops.flash_attention_bwd.launches == b0 + 1
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel(a, b) <= GRAD_TOL[dtype], _rel(a, b)
    # the log-sum-exp the forward hands over, and repeatability
    o, lse = faops._kernel.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    _, lse_ref = faref.flash_attention_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(lse, lse_ref, **TOL[dtype])
    again = faops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    once = faops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for a, b in zip(again, once):
        assert torch.equal(a, b)


# The bfloat16 backward's GQA clusters and edges: q_per_kv 4 and 8 (one
# cluster a kv head), 12 (two clusters of 6, summed by a second pass) and
# 11 (clusters of one); whisper-tiny's encoder (S 1,500, not causal);
# head_dims that are not a multiple of 16 (24; 20, read in 8-byte pieces)
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal", [
    (2, 96, 16, 4, 64, True), (1, 130, 16, 2, 128, True),
    (1, 100, 12, 1, 32, True), (1, 70, 11, 1, 64, False),
    (1, 1500, 6, 6, 64, False), (2, 77, 6, 2, 24, True),
    (1, 65, 4, 2, 20, False)])
def test_flash_bwd_bf16_groups_and_edges(gen, no_tf32, B, S, Hq, Hkv, hd,
                                         causal):
    dtype = torch.bfloat16
    q = torch.randn(B, S, Hq, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda").to(dtype)
    do = torch.randn(B, S, Hq, hd, generator=gen, device="cuda").to(dtype)
    want = _plain_grads(lambda a, b_, c: faref.flash_attention_ref(
        a, b_, c, causal=causal), (q, k, v), (do,))
    o, lse = faops._kernel.flash_attention_cuda(q, k, v, causal=causal,
                                                with_lse=True)
    b0 = faops.flash_attention_bwd.launches
    got = faops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = faops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert faops.flash_attention_bwd.launches == b0 + 2
    floor = _floor(want)
    for a, b, c in zip(got, want, again):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel(a, b, floor) <= GRAD_TOL[dtype], _rel(a, b, floor)
        assert torch.equal(a, c)


# The SSD scan's backward: S not a multiple of 64 and S 1 (one rank), a
# cluster of 2 to 5 ranks, zamba2's heads at 1,024 tokens (8 ranks of two
# chunks), a batch of 4 x 80 heads that fills the card, and strong decays
# (A uniform in [-80, -1], dt in [0, 1]), each with and without h0. Under
# strong decays autograd runs through the plain forward at 4-row chunks:
# at 64 rows its exp of a difference of two cumulative sums lies 1e-4 of a
# gradient's scale from the exact gradient in float32
# (tests/test_torch_ssm_bwd_numerics.py), while the kernel sums each
# exponent over the rows it spans.
SSD_BWD_CASES = [(2, 37, 3, 8, 4, False), (1, 130, 4, 64, 16, False),
                 (2, 65, 8, 64, 64, False), (1, 1, 2, 4, 8, False),
                 (1, 300, 80, 64, 64, False), (1, 1024, 80, 64, 64, False),
                 (4, 256, 80, 64, 64, False), (1, 512, 4, 32, 32, True),
                 (2, 256, 80, 64, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("Bb,S,H,P,N,strong", SSD_BWD_CASES)
@pytest.mark.parametrize("initial", [False, True])
def test_ssd_bwd_kernel_matches_autograd(gen, no_tf32, Bb, S, H, P, N,
                                         strong, initial):
    x = torch.randn(Bb, S, H, P, generator=gen, device="cuda")
    if strong:
        dt = torch.rand(Bb, S, H, generator=gen, device="cuda")
        A = -(1 + 79 * torch.rand(H, generator=gen, device="cuda"))
    else:
        dt = torch.nn.functional.softplus(
            torch.randn(Bb, S, H, generator=gen, device="cuda")) * 0.1
        A = -torch.exp(torch.randn(H, generator=gen, device="cuda"))
    B = torch.randn(Bb, S, N, generator=gen, device="cuda") * 0.3
    C = torch.randn(Bb, S, N, generator=gen, device="cuda") * 0.3
    h0 = (torch.randn(Bb, H, P, N, generator=gen, device="cuda")
          if initial else None)
    gy = torch.randn(Bb, S, H, P, generator=gen, device="cuda")
    gs = torch.randn(Bb, H, P, N, generator=gen, device="cuda")
    chunk = 4 if strong else 64
    want = _plain_grads(
        lambda *t: sref.ssd_chunked_ref(*t, chunk=chunk, initial_state=h0),
        (x, dt, A, B, C), (gy, gs))
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, B, C)]
    b0 = sops.ssm_scan_bwd.launches
    y, st = sops.ssm_scan(*leaves, initial_state=h0)
    assert type(y.grad_fn).__name__.startswith("_ScanFn")
    got = torch.autograd.grad((y * gy).sum() + (st * gs).sum(), leaves)
    assert sops.ssm_scan_bwd.launches == b0 + 1
    floor = _floor(want)
    for name, a, b in zip("x dt A B C".split(), got, want):
        assert a.shape == b.shape
        assert torch.isfinite(a).all(), name
        assert _rel(a, b, floor) <= 2e-5, (name, _rel(a, b, floor))
    again = sops.ssm_scan_bwd(x, dt, A, B, C, gy, gs, initial_state=h0)
    once = sops.ssm_scan_bwd(x, dt, A, B, C, gy, gs, initial_state=h0)
    for a, b in zip(again, once):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ssd_initial_state_gradient_raises(gen):
    x = torch.randn(1, 8, 2, 4, device="cuda", requires_grad=True)
    dt = torch.full((1, 8, 2), 0.1, device="cuda")
    A = -torch.ones(2, device="cuda")
    B = torch.randn(1, 8, 4, device="cuda")
    h0 = torch.zeros(1, 2, 4, 4, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError):
        sops.ssm_scan(x, dt, A, B, B.clone(), initial_state=h0)
