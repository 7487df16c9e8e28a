"""Paged KV cache (vLLM PagedAttention analogue, PyTorch).

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

Quantized pools (cfg.kv_dtype int8 / fp8) store each value as
round(x / scale) with one f32 scale per (page, kv head), in a scale tensor
(n_pages + 1, n_kv) beside each pool whose last row is the scratch page's.
Writes requantize whole pages: dequantize each touched page, overlay the new
tokens in f32, take the abs-max over the positions that hold a token, and
store page and scale together (`apply_quant_write`, with a `QuantPlan` built
once per model call). The pools are written through a uint8 view, since
PyTorch indexes no float8 tensor in place on the CPU; the same code runs on
the card. Reads dequantize inside the `_quant` kernels on a CUDA tensor and
through `gather_sequence_dequant` on a CPU tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.layers import TORCH_DTYPES


KV_QMAX = {"int8": 127.0, "fp8": 448.0}


def kv_storage_dtype(kv_dtype: str) -> torch.dtype:
    """torch dtype a paged pool stores for a resolved kv_dtype string."""
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "fp8":
        return torch.float8_e4m3fn
    return TORCH_DTYPES[kv_dtype]


def quant_scale(amax: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """Per-(page, kv-head) scale from the abs-max of its valid positions."""
    return torch.where(amax > 0, amax / KV_QMAX[kv_dtype],
                       torch.ones_like(amax))


def _quantize(x: torch.Tensor, scale: torch.Tensor, kv_dtype: str
              ) -> torch.Tensor:
    """x: f32 (..., page, kv, hd); scale: (..., kv) -> storage dtype. Both
    casts round half to even, as the JAX package's do. x / scale stays
    within +-448 for fp8 (the scale is amax / 448), where PyTorch's
    saturating cast and ml_dtypes' agree."""
    y = x / scale[..., None, :, None]
    if kv_dtype == "int8":
        return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
    return y.to(torch.float8_e4m3fn)


def _dequant_pages(pages: torch.Tensor, scales: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """Pages `idx` of a quantized pool as f32 (..., page, kv, hd)."""
    g = pages.view(torch.uint8)[idx].view(pages.dtype).float()
    return g * scales[idx][..., None, :, None]


def gather_sequence(pages: torch.Tensor, block_table: torch.Tensor
                    ) -> torch.Tensor:
    """pages: (n_pages, page, n_kv, hd); block_table: (B, P) ->
    contiguous (B, P*page, n_kv, hd). Unmapped (-1) pages read page 0 and
    must be masked by `lengths` downstream."""
    idx = block_table.clamp(min=0).long()
    g = pages[idx]                                   # (B, P, page, kv, hd)
    B, P, page, kv, hd = g.shape
    return g.reshape(B, P * page, kv, hd)


def gather_sequence_dequant(pages: torch.Tensor, scales: torch.Tensor,
                            block_table: torch.Tensor) -> torch.Tensor:
    """`gather_sequence` for a quantized pool: dequantize per (page, head)
    on read, returning contiguous f32 (B, P*page, n_kv, hd). scales:
    (n_pages, n_kv) f32."""
    g = _dequant_pages(pages, scales, block_table.clamp(min=0).long())
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


# ---------------------------------------------------------------------------
# Quantized writes: whole touched pages are rewritten. A QuantPlan lists the
# pages one model call touches and the masks its writes share across
# layers; `apply_quant_write` applies it to one layer's pool and scales.
# ---------------------------------------------------------------------------

class QuantPlan(NamedTuple):
    read: torch.Tensor      # (N,) page each rewrite starts from
    dest: torch.Tensor      # (N,) page it is stored to (scratch: dropped)
    src: torch.Tensor       # (N, page) row of the call's new K/V rows
    inchunk: torch.Tensor   # (N, page) position takes a new token
    valid: torch.Tensor     # (N, page) position holds a token afterwards


def token_quant_plan(block_table: torch.Tensor, lengths: torch.Tensor,
                     pages: torch.Tensor,
                     active: Optional[torch.Tensor] = None) -> QuantPlan:
    """One token per slot at its current length (`write_token_quant`): each
    slot's tail page, with positions past the new token zeroed out of the
    abs-max and the stored page. Unmapped (-1) and inactive rows drop."""
    n_pages, page_size = pages.shape[0], pages.shape[1]
    P = block_table.shape[1]
    pos = lengths.long()
    col = (pos // page_size).clamp(0, P - 1)
    page_of = torch.gather(block_table, 1, col[:, None])[:, 0].long()
    off = pos % page_size
    keep = page_of >= 0
    if active is not None:
        keep = keep & active
    dest = torch.where(keep, page_of, n_pages - 1)
    ar = torch.arange(page_size, device=pos.device)
    src = torch.arange(pos.shape[0], device=pos.device)[:, None].expand(
        -1, page_size)
    return QuantPlan(dest, dest, src, ar[None, :] == off[:, None],
                     ar[None, :] <= off[:, None])


def prompt_quant_plan(block_rows: torch.Tensor, offsets: torch.Tensor,
                      lens: torch.Tensor, C: int, pages: torch.Tensor
                      ) -> QuantPlan:
    """R rows of C chunk tokens at offsets[r].. with lens[r] valid
    (`write_prompt_ragged_quant`): the C // page + 2 pages a chunk can
    touch, per row. Tokens earlier chunks placed on the first touched page
    are dequantized, merged and requantized under the page's new scale.
    Touched pages past the block table read as unmapped. (The JAX package's
    single-slot writer clips them to the last column instead; the two
    differ only for a chunk that overruns its table, which the engine never
    writes.)"""
    n_pages, page_size = pages.shape[0], pages.shape[1]
    R, P = block_rows.shape
    dev = block_rows.device
    T = C // page_size + 2
    offsets, lens = offsets.long(), lens.long()
    logical = (offsets // page_size)[:, None] + torch.arange(T, device=dev)
    page_ids = torch.gather(block_rows, 1, logical.clamp(max=P - 1)).long()
    page_ids = torch.where(logical < P, page_ids, -1)
    kpos = logical[:, :, None] * page_size + torch.arange(page_size,
                                                          device=dev)
    chunk_idx = kpos - offsets[:, None, None]                  # (R, T, pg)
    inchunk = (chunk_idx >= 0) & (chunk_idx < lens[:, None, None])
    valid = (kpos < (offsets + lens)[:, None, None]) \
        & (page_ids >= 0)[:, :, None]
    src = torch.arange(R, device=dev)[:, None, None] * C \
        + chunk_idx.clamp(0, C - 1)
    writes = inchunk.any(dim=2) & (page_ids >= 0)
    dest = torch.where(writes, page_ids, n_pages - 1)
    N = R * T
    return QuantPlan(page_ids.clamp(min=0).reshape(N), dest.reshape(N),
                     src.reshape(N, page_size),
                     inchunk.reshape(N, page_size),
                     valid.reshape(N, page_size))


def apply_quant_write(pages: torch.Tensor, scales: torch.Tensor,
                      plan: QuantPlan, new: torch.Tensor, kv_dtype: str
                      ) -> None:
    """Rewrite the plan's pages of one layer's quantized pool in place.

    pages: (n_pages, page, kv, hd) int8 / float8_e4m3fn, the last page
    scratch; scales: (n_pages, kv) f32; new: (M, kv, hd) the call's new K
    or V rows, indexed by `plan.src`."""
    deq = _dequant_pages(pages, scales, plan.read)       # (N, pg, kv, hd)
    deq = torch.where(plan.inchunk[:, :, None, None], new.float()[plan.src],
                      deq)
    deq = torch.where(plan.valid[:, :, None, None], deq, 0.0)
    amax = deq.abs().amax(dim=(1, 3))                     # (N, kv)
    scale = quant_scale(amax, kv_dtype)
    pages.view(torch.uint8).index_copy_(
        0, plan.dest, _quantize(deq, scale, kv_dtype).view(torch.uint8))
    scales.index_copy_(0, plan.dest, scale)


def write_token_quant(pages_k: torch.Tensor, pages_v: torch.Tensor,
                      scales_k: torch.Tensor, scales_v: torch.Tensor,
                      block_table: torch.Tensor, lengths: torch.Tensor,
                      new_k: torch.Tensor, new_v: torch.Tensor,
                      kv_dtype: str,
                      active: Optional[torch.Tensor] = None) -> None:
    """`write_token` for a quantized pool, in place: requantize each slot's
    tail page. The tail page is always uniquely owned (COW copies partial
    tails eagerly), so rewriting the whole page never clobbers a sibling.
    new_*: (B, 1, kv, hd)."""
    plan = token_quant_plan(block_table, lengths, pages_k, active)
    apply_quant_write(pages_k, scales_k, plan, new_k[:, 0], kv_dtype)
    apply_quant_write(pages_v, scales_v, plan, new_v[:, 0], kv_dtype)


def write_prompt_quant(pages_k: torch.Tensor, pages_v: torch.Tensor,
                       scales_k: torch.Tensor, scales_v: torch.Tensor,
                       block_row: torch.Tensor, new_k: torch.Tensor,
                       new_v: torch.Tensor, prompt_len, kv_dtype: str,
                       offset=0) -> None:
    """`write_prompt` for a quantized pool, in place. new_*: (1, S, kv, hd)
    right-padded; prompt_len valid tokens written at offset.."""
    dev = block_row.device
    offs = torch.as_tensor(offset, dtype=torch.int32, device=dev).reshape(1)
    lens = torch.as_tensor(prompt_len, dtype=torch.int32,
                           device=dev).reshape(1)
    S = new_k.shape[1]
    plan = prompt_quant_plan(block_row[None], offs, lens, S, pages_k)
    apply_quant_write(pages_k, scales_k, plan, new_k[0], kv_dtype)
    apply_quant_write(pages_v, scales_v, plan, new_v[0], kv_dtype)


def write_prompt_ragged_quant(pages_k: torch.Tensor, pages_v: torch.Tensor,
                              scales_k: torch.Tensor, scales_v: torch.Tensor,
                              block_rows: torch.Tensor, new_k: torch.Tensor,
                              new_v: torch.Tensor, lens: torch.Tensor,
                              offsets: torch.Tensor, kv_dtype: str) -> None:
    """`write_prompt_ragged` for a quantized pool, in place: R slots'
    chunks in one shot. Distinct slots own distinct pages, so the flattened
    (R * touched) page rewrite never collides across rows."""
    R, C = new_k.shape[0], new_k.shape[1]
    plan = prompt_quant_plan(block_rows, offsets, lens, C, pages_k)
    apply_quant_write(pages_k, scales_k, plan,
                      new_k.reshape(R * C, *new_k.shape[2:]), kv_dtype)
    apply_quant_write(pages_v, scales_v, plan,
                      new_v.reshape(R * C, *new_v.shape[2:]), kv_dtype)


def copy_page(pages: torch.Tensor, src: int, dst: int) -> None:
    """Copy one physical page across all layers of a segment's pool, in
    place. pages: (count, n_pages, page, kv, hd), or a scale tensor
    (count, n_pages, kv). src == dst is a no-op, used when a fork has no
    partial tail page to duplicate."""
    if src != dst:
        pages[:, dst].copy_(pages[:, src])


@dataclasses.dataclass
class PageAllocator:
    """Host-side page bookkeeping: free list + per-slot page chains, with
    per-page refcounts so forks can share read-only prefix pages
    copy-on-write (`fork` / `cow_page`). A page returns to the free list
    only when its last reference is released."""
    n_pages: int
    page_size: int
    max_pages_per_seq: int

    def __post_init__(self):
        self.free: List[int] = list(range(self.n_pages))
        self.owned: Dict[int, List[int]] = {}
        self.refcount: List[int] = [0] * self.n_pages
        # Host tier: req_id -> {"resident": [(logical_idx, page_id)],
        # "swapped_idx": [logical_idx]}. Demoted requests keep shared pages
        # resident (their reference is held, so siblings can't free them)
        # and surrender uniquely-owned pages to the free list once the
        # engine has snapshotted their bytes to host memory.
        self.hosted: Dict = {}

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

    def demote(self, slot: int, req_id) -> List[Tuple[int, int]]:
        """Move a slot's chain to the host tier instead of freeing it.

        Uniquely-owned pages are freed for reuse and listed as swapped —
        the caller must snapshot their bytes before anything can rewrite
        them (the pools are written in place). Shared pages stay resident
        with this chain's reference held, so COW siblings cannot free them
        and `promote` re-shares them in place. Returns [(logical_idx,
        page_id)] for the swapped pages."""
        pages = self.owned.pop(slot)
        resident: List[Tuple[int, int]] = []
        swapped: List[Tuple[int, int]] = []
        for i, p in enumerate(pages):
            if self.refcount[p] == 1:
                swapped.append((i, p))
                self.refcount[p] = 0
                self.free.append(p)
            else:
                resident.append((i, p))
        self.hosted[req_id] = {"resident": resident,
                               "swapped_idx": [i for i, _ in swapped]}
        return swapped

    def promote(self, req_id, slot: int) -> List[Tuple[int, int]]:
        """Re-admit a demoted request into `slot`: fresh device pages for
        the swapped logical indices (MemoryError when the pool is dry),
        resident shared pages rejoin the chain with their held reference.
        Returns [(logical_idx, new_page_id)] upload targets for the host
        bytes, in logical order."""
        ent = self.hosted[req_id]
        assert slot not in self.owned, "destination slot still owns pages"
        if len(self.free) < len(ent["swapped_idx"]):
            raise MemoryError("page pool exhausted")
        uploads = [(i, self._take()) for i in ent["swapped_idx"]]
        chain = dict(uploads)
        chain.update(ent["resident"])
        self.owned[slot] = [chain[i] for i in sorted(chain)]
        del self.hosted[req_id]
        return uploads

    def drop_hosted(self, req_id) -> None:
        """Abandon a demoted request, releasing its held resident refs."""
        ent = self.hosted.pop(req_id, None)
        if ent is None:
            return
        for _, p in ent["resident"]:
            self.refcount[p] -= 1
            assert self.refcount[p] >= 0, "refcount underflow"
            if self.refcount[p] == 0:
                self.free.append(p)

    def hosted_pages(self, req_id) -> int:
        """Swapped page count a promote of req_id must allocate."""
        return len(self.hosted[req_id]["swapped_idx"])

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
