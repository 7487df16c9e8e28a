"""The port's CUDA kernels against their plain versions on the card. These
need an NVIDIA card and skip without one; on the card run

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py imports jax, which a machine
with only the port installed may lack.)
"""
import pytest
import torch

from repro_torch.kernels.paged_decode_attention import ops as dops
from repro_torch.kernels.paged_decode_attention import ref as dref
from repro_torch.kernels.paged_prefill_attention import ops as pops
from repro_torch.kernels.paged_prefill_attention import ref as pref

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
                                              (12, 2, 128, 32, 64)])
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
