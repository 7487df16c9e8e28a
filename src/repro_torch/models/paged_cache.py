"""Paged KV cache (vLLM PagedAttention analogue, PyTorch), float pools.

Physical storage is a page pool per layer; sequences map to pages through a
block table, so slot memory is allocated on demand and freed on completion.
The read path is the tensor's device: on a CUDA tensor the hand-written
paged-attention kernels stream mapped pages through the block table; on a
CPU tensor `gather_sequence` below materializes the contiguous layout for
the plain attention.

Layout:
  pages:       (L, n_pages + 1, page_size, n_kv, hd)  (last page: scratch)
  block_table: (B, max_pages_per_seq) int32  (-1 = unmapped)
  lengths:     (B,) int32

Writers update the pools IN PLACE (the JAX package returns new arrays).
Every pool holds one scratch page past the pages the allocator hands out:
its LAST page, which no block table maps and nothing reads. Where the JAX
package scatters with mode="drop", the writers here send each dropped
element (padding row, unmapped -1 page, inactive row) to that page, so a
pool write is one index_copy_ with no device->host sync. Gathers clamp
indices where the JAX package uses mode="clip".

Quantized pools (int8/fp8) and their writers are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models.layers import TORCH_DTYPES


def kv_storage_dtype(kv_dtype: str) -> torch.dtype:
    """torch dtype a paged pool stores for a resolved kv_dtype string."""
    if kv_dtype in ("int8", "fp8"):
        raise NotImplementedError(
            "quantized KV pools wait for the quantized-pool slice")
    return TORCH_DTYPES[kv_dtype]


def gather_sequence(pages: torch.Tensor, block_table: torch.Tensor
                    ) -> torch.Tensor:
    """pages: (n_pages, page, n_kv, hd); block_table: (B, P) ->
    contiguous (B, P*page, n_kv, hd). Unmapped (-1) pages read page 0 and
    must be masked by `lengths` downstream."""
    idx = block_table.clamp(min=0).long()
    g = pages[idx]                                   # (B, P, page, kv, hd)
    B, P, page, kv, hd = g.shape
    return g.reshape(B, P * page, kv, hd)


# ---------------------------------------------------------------------------
# Write plans: the flat pool row each new token goes to, computed once per
# model call and applied to every layer's pools.
# ---------------------------------------------------------------------------

def _plan(page_of: torch.Tensor, off: torch.Tensor, keep: torch.Tensor,
          pages: torch.Tensor) -> torch.Tensor:
    """Flat row page * page_size + off for kept elements, the scratch
    page's first row for dropped ones. `pages` is a layer pool; only its
    shape is read."""
    n_pages, page_size = pages.shape[0], pages.shape[1]
    dest = page_of.long() * page_size + off.long()
    return torch.where(keep, dest, (n_pages - 1) * page_size)


def token_write_plan(block_table: torch.Tensor, lengths: torch.Tensor,
                     pages: torch.Tensor,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token per slot at its current length (see `write_token`)."""
    P, page_size = block_table.shape[1], pages.shape[1]
    col = (lengths.long() // page_size).clamp(0, P - 1)
    page_of = torch.gather(block_table, 1, col[:, None])[:, 0]
    keep = page_of >= 0
    if active is not None:
        keep = keep & active
    return _plan(page_of, lengths.long() % page_size, keep, pages)


def prompt_write_plan(block_rows: torch.Tensor, offsets: torch.Tensor,
                      lens: torch.Tensor, C: int, pages: torch.Tensor
                      ) -> torch.Tensor:
    """R rows of C chunk tokens at offsets[r].. with lens[r] valid (see
    `write_prompt_ragged`), flattened row-major to N = R*C elements."""
    P, page_size = block_rows.shape[1], pages.shape[1]
    ar = torch.arange(C, device=block_rows.device)
    pos = offsets.long()[:, None] + ar[None, :]                     # (R, C)
    col = (pos // page_size).clamp(0, P - 1)
    page_of = torch.gather(block_rows, 1, col)
    keep = (ar[None, :] < lens.long()[:, None]) & (page_of >= 0)
    return _plan(page_of.reshape(-1), (pos % page_size).reshape(-1),
                 keep.reshape(-1), pages)


def apply_write(pages: torch.Tensor, dest: torch.Tensor, new: torch.Tensor
                ) -> None:
    """pages: (n_pages, page, kv, hd) written in place; dest: (N,) flat
    rows from a write plan; new: (N, kv, hd)."""
    flat = pages.view(pages.shape[0] * pages.shape[1], -1)
    flat.index_copy_(0, dest, new.reshape(new.shape[0], -1).to(pages.dtype))


def write_token(pages_k: torch.Tensor, pages_v: torch.Tensor,
                block_table: torch.Tensor, lengths: torch.Tensor,
                new_k: torch.Tensor, new_v: torch.Tensor,
                active: Optional[torch.Tensor] = None) -> None:
    """Write one token per slot at its current length, in place.

    pages_*: (n_pages, page, kv, hd), the last page scratch; new_*: (B, 1,
    kv, hd). `active` (B,)
    bool, when given, drops inactive rows' writes entirely — the engine
    pushes freed rows' block-table clears lazily (at most one table transfer
    per step), so a freed slot's stale row may still map pages a COW sibling
    owns; masking here keeps those pages untouched. Unmapped (-1) rows drop
    too."""
    dest = token_write_plan(block_table, lengths, pages_k, active)
    apply_write(pages_k, dest, new_k[:, 0])
    apply_write(pages_v, dest, new_v[:, 0])


def write_prompt(pages_k: torch.Tensor, pages_v: torch.Tensor,
                 block_row: torch.Tensor, new_k: torch.Tensor,
                 new_v: torch.Tensor, prompt_len, offset=0) -> None:
    """Scatter one sequence's prompt (or prompt chunk) K/V, in place.

    block_row: (P,); new_*: (1, S, kv, hd) right-padded; prompt_len: valid
    count in new_*; offset: logical position of new_*[0, 0]."""
    dev = block_row.device
    offs = torch.as_tensor(offset, dtype=torch.int32, device=dev).reshape(1)
    lens = torch.as_tensor(prompt_len, dtype=torch.int32,
                           device=dev).reshape(1)
    write_prompt_ragged(pages_k, pages_v, block_row[None], new_k, new_v,
                        lens, offs)


def write_prompt_ragged(pages_k: torch.Tensor, pages_v: torch.Tensor,
                        block_rows: torch.Tensor, new_k: torch.Tensor,
                        new_v: torch.Tensor, lens: torch.Tensor,
                        offsets: torch.Tensor) -> None:
    """Scatter R slots' prompt chunks into their pages in one shot, in place.

    Row r holds slot r's next chunk, right-padded to C with `lens[r]` valid
    tokens, written at logical positions offsets[r]..offsets[r]+lens[r]-1
    through that slot's block-table row. Padding rows (lens == 0) and
    unmapped (-1) pages write nothing.

    pages_*: (n_pages, page, kv, hd), the last page scratch; block_rows:
    (R, P); new_*: (R, C, kv, hd); lens/offsets: (R,)."""
    R, C = new_k.shape[0], new_k.shape[1]
    dest = prompt_write_plan(block_rows, offsets, lens, C, pages_k)
    apply_write(pages_k, dest, new_k.reshape(R * C, *new_k.shape[2:]))
    apply_write(pages_v, dest, new_v.reshape(R * C, *new_v.shape[2:]))


def copy_page(pages: torch.Tensor, src: int, dst: int) -> None:
    """Copy one physical page across all layers of a segment's pool, in
    place. pages: (count, n_pages, page, kv, hd). src == dst is a no-op,
    used when a fork has no partial tail page to duplicate."""
    if src != dst:
        pages[:, dst].copy_(pages[:, src])


@dataclasses.dataclass
class PageAllocator:
    """Host-side page bookkeeping: free list + per-slot page chains, with
    per-page refcounts so forks can share read-only prefix pages
    copy-on-write (`fork` / `cow_page`). A page returns to the free list
    only when its last reference is released. (The host tier's demote /
    promote waits for the host-swap slice.)"""
    n_pages: int
    page_size: int
    max_pages_per_seq: int

    def __post_init__(self):
        self.free: List[int] = list(range(self.n_pages))
        self.owned: Dict[int, List[int]] = {}
        self.refcount: List[int] = [0] * self.n_pages

    def _take(self) -> int:
        p = self.free.pop()
        self.refcount[p] = 1
        return p

    def alloc_for(self, slot: int, n_tokens: int) -> List[int]:
        need = max(1, -(-n_tokens // self.page_size))
        assert need <= self.max_pages_per_seq, "sequence exceeds block table"
        if len(self.free) < need:
            raise MemoryError("page pool exhausted")
        pages = [self._take() for _ in range(need)]
        self.owned[slot] = pages
        return pages

    def extend(self, slot: int, new_len: int) -> Optional[int]:
        """Grow slot to cover new_len tokens; returns new page id if mapped."""
        pages = self.owned.get(slot, [])
        need = max(1, -(-new_len // self.page_size))
        if need <= len(pages):
            return None
        if not self.free:
            raise MemoryError("page pool exhausted")
        p = self._take()
        pages.append(p)
        self.owned[slot] = pages
        return p

    def fork(self, src_slot: int, dst_slot: int, n_tokens: int
             ) -> Tuple[List[int], int, int]:
        """Share src's first `n_tokens` of pages with dst copy-on-write.

        Full pages are shared (refcount++); a partial tail page — the page
        the next token write would land in — is copied into a fresh page so
        the fork can append without touching its siblings. Returns
        (dst_pages, tail_src, tail_dst); tail ids are equal when the prefix
        is page-aligned and nothing needs a device-side copy."""
        src_pages = self.owned[src_slot]
        assert dst_slot not in self.owned, "destination slot still owns pages"
        assert 0 < n_tokens <= len(src_pages) * self.page_size
        full = n_tokens // self.page_size
        shared = src_pages[:full]
        tail_src = tail_dst = 0
        if n_tokens % self.page_size:
            if not self.free:
                raise MemoryError("page pool exhausted")
            tail_src = src_pages[full]
            tail_dst = self._take()
        for p in shared:
            self.refcount[p] += 1
        dst_pages = list(shared)
        if tail_src != tail_dst:
            dst_pages.append(tail_dst)
        self.owned[dst_slot] = dst_pages
        return dst_pages, tail_src, tail_dst

    def fork_cost(self, n_tokens: int) -> int:
        """Free pages a fork of an n_tokens prefix consumes now (0 or 1)."""
        return 1 if n_tokens % self.page_size else 0

    def cow_page(self, slot: int, pos: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write guard before writing token position `pos`: if the
        page holding it is shared, re-point the slot at a private copy.
        Returns (old_page, new_page) for the device-side copy, or None when
        the page is already uniquely owned."""
        pages = self.owned.get(slot, [])
        idx = pos // self.page_size
        if idx >= len(pages):
            return None
        p = pages[idx]
        if self.refcount[p] <= 1:
            return None
        if not self.free:
            raise MemoryError("page pool exhausted")
        new = self._take()
        self.refcount[p] -= 1
        pages[idx] = new
        return p, new

    def release(self, slot: int) -> None:
        for p in self.owned.pop(slot, []):
            self.refcount[p] -= 1
            assert self.refcount[p] >= 0, "refcount underflow"
            if self.refcount[p] == 0:
                self.free.append(p)

    def unique_pages(self, slot: int) -> int:
        """Pages only this slot references — what releasing it would free."""
        return sum(1 for p in self.owned.get(slot, [])
                   if self.refcount[p] == 1)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self.free)

    @property
    def pages_shared(self) -> int:
        """Physical pages referenced by more than one slot."""
        return sum(1 for c in self.refcount if c > 1)

    @property
    def logical_pages(self) -> int:
        """Sum of per-slot chain lengths (counts shared pages per reference);
        logical - in_use is the memory COW sharing is saving."""
        return sum(len(v) for v in self.owned.values())

    @property
    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.n_pages
