"""models/paged_cache.py of the port against the JAX package's on an
identical pool state: the writers (with padding-row, unmapped -1 and
inactive-row drops), the gather, copy_page, and the PageAllocator."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (thread count)
from repro.models import paged_cache as jpc
from repro_torch.models import paged_cache as tpc

# the port's writers send dropped elements to the pool's last page (the
# scratch page, mapped by no block table): writer tests compare the rest
N_PAGES, PAGE, KV, HD = 9, 8, 2, 4


def _pools(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N_PAGES, PAGE, KV, HD)).astype(np.float32),
            rng.standard_normal((N_PAGES, PAGE, KV, HD)).astype(np.float32))


def _both(kp, vp):
    return (torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()),
            jnp.asarray(kp), jnp.asarray(vp))


def _equal(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _equal_but_scratch(t, j):
    _equal(t[:-1], j[:-1])


# block table: row 0 maps pages 3,4; row 1 maps 5 then -1; row 2 shares
# page 3 with row 0 (a COW sibling) and maps 6; row 3 is unmapped
TABLE = np.array([[3, 4, -1], [5, -1, -1], [3, 6, -1], [-1, -1, -1]],
                 np.int32)


@pytest.mark.parametrize("active", [None, [True, False, True, True]])
@pytest.mark.parametrize("lengths", [[9, 3, 12, 0], [15, 8, 0, 5]])
def test_write_token(lengths, active):
    """Drops: an inactive row (row 1), a row whose page is -1 (row 1 at
    length 8, row 3), and positions past the table width never write."""
    kp, vp = _pools()
    tk, tv, jk, jv = _both(kp, vp)
    rng = np.random.default_rng(1)
    nk = rng.standard_normal((4, 1, KV, HD)).astype(np.float32)
    nv = rng.standard_normal((4, 1, KV, HD)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    act_t = None if active is None else torch.tensor(active)
    act_j = None if active is None else jnp.asarray(active)
    tpc.write_token(tk, tv, torch.from_numpy(TABLE), torch.from_numpy(lens),
                    torch.from_numpy(nk), torch.from_numpy(nv), active=act_t)
    jk, jv = jpc.write_token(jk, jv, jnp.asarray(TABLE), jnp.asarray(lens),
                             jnp.asarray(nk), jnp.asarray(nv), active=act_j)
    _equal_but_scratch(tk, jk)
    _equal_but_scratch(tv, jv)
    # nothing outside the kept writes changed, page 0 in particular
    np.testing.assert_array_equal(tk[0].numpy(), kp[0])


def test_write_prompt_ragged_with_padding_rows():
    kp, vp = _pools(2)
    tk, tv, jk, jv = _both(kp, vp)
    rng = np.random.default_rng(3)
    R, C = 4, 6
    nk = rng.standard_normal((R, C, KV, HD)).astype(np.float32)
    nv = rng.standard_normal((R, C, KV, HD)).astype(np.float32)
    rows = TABLE[[0, 1, 2, 3]]
    # row 1 runs into its unmapped second page; row 3 is a padding row
    offs = np.array([5, 4, 10, 0], np.int32)
    lens = np.array([6, 6, 3, 0], np.int32)
    tpc.write_prompt_ragged(tk, tv, torch.from_numpy(rows),
                            torch.from_numpy(nk), torch.from_numpy(nv),
                            torch.from_numpy(lens), torch.from_numpy(offs))
    jk, jv = jpc.write_prompt_ragged(jk, jv, jnp.asarray(rows),
                                     jnp.asarray(nk), jnp.asarray(nv),
                                     jnp.asarray(lens), jnp.asarray(offs))
    _equal_but_scratch(tk, jk)
    _equal_but_scratch(tv, jv)
    np.testing.assert_array_equal(tk[0].numpy(), kp[0])


@pytest.mark.parametrize("offset,plen", [(0, 11), (3, 5), (14, 4)])
def test_write_prompt(offset, plen):
    kp, vp = _pools(4)
    tk, tv, jk, jv = _both(kp, vp)
    rng = np.random.default_rng(5)
    nk = rng.standard_normal((1, 16, KV, HD)).astype(np.float32)
    nv = rng.standard_normal((1, 16, KV, HD)).astype(np.float32)
    row = TABLE[0]
    tpc.write_prompt(tk, tv, torch.from_numpy(row), torch.from_numpy(nk),
                     torch.from_numpy(nv), plen, offset=offset)
    jk, jv = jpc.write_prompt(jk, jv, jnp.asarray(row), jnp.asarray(nk),
                              jnp.asarray(nv), jnp.asarray(plen),
                              offset=offset)
    _equal_but_scratch(tk, jk)
    _equal_but_scratch(tv, jv)


def test_gather_sequence_and_copy_page():
    kp, _ = _pools(6)
    _equal(tpc.gather_sequence(torch.from_numpy(kp), torch.from_numpy(TABLE)),
           jpc.gather_sequence(jnp.asarray(kp), jnp.asarray(TABLE)))
    stacked = np.stack([kp, kp[::-1].copy()])
    t = torch.from_numpy(stacked.copy())
    tpc.copy_page(t, 2, 7)
    _equal(t, jpc.copy_page(jnp.asarray(stacked), 2, 7))
    tpc.copy_page(t, 4, 4)
    _equal(t, jpc.copy_page(jnp.asarray(stacked), 2, 7))


def _alloc_script(alloc):
    """One sequence of allocator operations, returning every result."""
    out = [alloc.alloc_for(0, 20), alloc.alloc_for(1, 9)]
    out.append(alloc.fork(0, 2, 20))
    out.append(alloc.cow_page(2, 16))
    out.append(alloc.cow_page(2, 3))
    out.append(alloc.extend(1, 17))
    out.append(alloc.fork(1, 3, 16))
    out.append(alloc.cow_page(3, 8))
    out.append((alloc.unique_pages(0), alloc.pages_shared,
                alloc.logical_pages, alloc.fork_cost(20)))
    alloc.release(0)
    out.append(alloc.extend(2, 30))
    alloc.release(1)
    out.append((alloc.pages_in_use, alloc.utilization))
    try:
        alloc.alloc_for(4, 8 * 20)
    except (MemoryError, AssertionError) as exc:
        out.append(type(exc).__name__)
    alloc.release(2)
    alloc.release(3)
    out.append((sorted(alloc.free), list(alloc.refcount), alloc.owned))
    return out


def test_page_allocator_same_state_as_reference():
    assert _alloc_script(tpc.PageAllocator(12, 8, 6)) \
        == _alloc_script(jpc.PageAllocator(12, 8, 6))
