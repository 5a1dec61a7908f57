"""Paged KV cache: a physical page pool on the device plus a host-side
slot allocator with refcounts.

Each cached tensor lives in one pool ``[layers, num_pages, page_size,
*feat]``; each slot owns an ordered list of page ids (its row of the page
table) mapping logical position ``p`` to ``(table[p // page_size],
p % page_size)``.  ``paged_gather`` rebuilds the logical-order dense view
``[slots, max_len, *feat]``, so attention over the pool equals attention
over the dense cache it replaces.  Allocation is host-side (numpy and a
free list) between device steps; page tables and lengths ship to the
device as small int tensors.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

PAGE_FREE = -1


class OutOfPagesError(RuntimeError):
    """The free list cannot cover a requested allocation."""


class PageAliasError(RuntimeError):
    """A page's references disagree with its refcount (or a page is both
    live and free)."""


class PageLeakError(PageAliasError):
    """A page kept a reference after every request was freed."""


def pages_for(tokens: int, page_size: int) -> int:
    """Number of pages covering ``tokens`` token positions."""
    return -(-int(tokens) // page_size) if tokens > 0 else 0


def leaf_specs_for(cfg) -> dict:
    """Per-token cached tensors for ``cfg``: ``{name: (feat, dtype)}``."""
    if cfg.attention_kind != "gqa" or cfg.resolved_cache_kind != "full":
        raise NotImplementedError(
            f"paged KV cache supports full-cache GQA archs; got "
            f"attention_kind={cfg.attention_kind!r} / "
            f"cache={cfg.resolved_cache_kind!r}")
    feat = (cfg.num_kv_heads, cfg.head_dim)
    return {"pages_k": (feat, cfg.kvdtype), "pages_v": (feat, cfg.kvdtype)}


# ------------------------------------------------------- device-side ops
def paged_gather(pages: torch.Tensor, page_table: torch.Tensor,
                 page_size: int) -> torch.Tensor:
    """Dense logical view of a paged pool.

    pages: [P, page_size, *feat]; page_table: [B, n_view] (-1 = unmapped).
    Returns [B, n_view * page_size, *feat]; unmapped pages read physical
    page 0 (callers mask them by position)."""
    p_phys = pages.shape[0]
    feat = pages.shape[2:]
    b, n_view = page_table.shape
    flat = pages.reshape(p_phys * page_size, *feat)
    base = torch.where(page_table >= 0, page_table, 0).long() * page_size
    idx = base[:, :, None] + torch.arange(page_size,
                                          device=pages.device)[None, None]
    return flat[idx.reshape(b, n_view * page_size)]


def paged_update(pages: torch.Tensor, new: torch.Tensor,
                 page_table: torch.Tensor, lens: torch.Tensor,
                 page_size: int, write_mask=None) -> torch.Tensor:
    """Write ``new[b, i]`` to logical position ``lens[b] + i`` of slot b,
    IN PLACE, and return ``pages``.

    Writes through unmapped table entries (-1), past the table end, or for
    rows whose ``write_mask`` is False are dropped, as the reference's
    ``mode="drop"`` scatter drops them; torch has no drop mode, so the
    valid writes are selected first (this syncs with the host)."""
    p_phys = pages.shape[0]
    feat = pages.shape[2:]
    b, s = new.shape[0], new.shape[1]
    n_view = page_table.shape[1]
    pos = lens.long()[:, None] + torch.arange(s, device=pages.device)[None]
    page_idx = pos // page_size
    phys = torch.gather(page_table.long(), 1,
                        page_idx.clamp(0, n_view - 1))
    valid = (phys >= 0) & (page_idx < n_view)
    if write_mask is not None:
        valid = valid & write_mask[:, None]
    flat_idx = (phys * page_size + pos % page_size)[valid]
    flat = pages.view(p_phys * page_size, *feat)
    flat[flat_idx] = new.reshape(b, s, *feat)[valid].to(flat.dtype)
    return pages


# ------------------------------------------------------ host-side pool
class PagedKVCache:
    """Physical page pool + per-slot page tables and length counters.

    ``self.pages`` holds the device pools (written in place by the serving
    steps); ``page_table`` / ``lens`` live here as numpy and ship per call
    via ``table_device()`` / ``lens_device()``."""

    def __init__(self, *, num_layers: int, num_slots: int, max_len: int,
                 page_size: int, leaf_specs: dict,
                 num_pages: int | None = None, device=None):
        if max_len % page_size:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"page_size={page_size} so the gathered view "
                             f"matches the dense cache length exactly")
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_slot = max_len // page_size
        self.num_pages = (num_pages if num_pages is not None
                          else num_slots * self.pages_per_slot)
        self.device = torch.device("cpu" if device is None else device)
        self.pages = {
            name: torch.zeros((num_layers, self.num_pages, page_size, *feat),
                              dtype=dtype, device=self.device)
            for name, (feat, dtype) in leaf_specs.items()}
        self.page_table = np.full((num_slots, self.pages_per_slot),
                                  PAGE_FREE, np.int32)
        self.lens = np.zeros((num_slots,), np.int32)
        self._n_pages = np.zeros((num_slots,), np.int32)
        self._free: collections.deque[int] = collections.deque(
            range(self.num_pages))
        self.refcount = np.zeros((self.num_pages,), np.int32)

    # ------------------------------------------------------- allocation
    @property
    def free_count(self) -> int:
        return len(self._free)

    def held(self, slot: int) -> int:
        """Pages currently mapped by ``slot``."""
        return int(self._n_pages[slot])

    def _take_free(self, why: str) -> int:
        if not self._free:
            raise OutOfPagesError(f"{why} but the free list is empty "
                                  f"({self.num_pages} pages total)")
        p = self._free.popleft()
        self.refcount[p] = 1
        return p

    def _release(self, p: int) -> bool:
        """Drop one reference to ``p``; True if it returned to the free
        list."""
        if self.refcount[p] <= 0:
            raise PageAliasError(f"double free of page {p}")
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            self._free.append(p)
            return True
        return False

    def alloc(self, slot: int, token_len: int) -> None:
        """Grow ``slot``'s mapping to cover ``token_len`` logical tokens."""
        target = pages_for(token_len, self.page_size)
        if target > self.pages_per_slot:
            raise ValueError(f"slot {slot}: {token_len} tokens exceed "
                             f"max_len={self.max_len}")
        while self._n_pages[slot] < target:
            p = self._take_free(
                f"slot {slot} needs page {int(self._n_pages[slot])}")
            self.page_table[slot, self._n_pages[slot]] = p
            self._n_pages[slot] += 1

    def free(self, slot: int) -> list[int]:
        """Release every reference of ``slot``; returns the ids that came
        back to the free list."""
        n = int(self._n_pages[slot])
        freed = [p for p in map(int, self.page_table[slot, :n])
                 if self._release(p)]
        self.page_table[slot, :] = PAGE_FREE
        self._n_pages[slot] = 0
        self.lens[slot] = 0
        return freed

    # -------------------------------------------------- device shipping
    def table_device(self, slots=None) -> torch.Tensor:
        t = self.page_table if slots is None else self.page_table[slots]
        return torch.from_numpy(np.ascontiguousarray(t)).to(self.device)

    def lens_device(self, slots=None) -> torch.Tensor:
        ln = self.lens if slots is None else self.lens[slots]
        return torch.from_numpy(np.ascontiguousarray(ln)).to(self.device)

    # ---------------------------------------------------- invariants
    def check_no_aliasing(self) -> None:
        """Raise PageAliasError unless table references, refcounts and the
        free list agree and free + live partitions the pool."""
        refs = np.zeros((self.num_pages,), np.int64)
        for row in self.page_table:
            for p in row:
                if p >= 0:
                    refs[p] += 1
        bad = np.flatnonzero(refs != self.refcount)
        if bad.size:
            detail = ", ".join(
                f"page {p}: {refs[p]} table refs vs refcount "
                f"{int(self.refcount[p])}" for p in bad[:4])
            raise PageAliasError(f"refcount mismatch ({detail})")
        free = list(self._free)
        if len(free) != len(set(free)):
            dup = sorted(p for p in set(free) if free.count(p) > 1)
            raise PageAliasError(f"pages {dup} twice on the free list")
        overlap = set(free) & set(np.flatnonzero(refs > 0).tolist())
        if overlap:
            raise PageAliasError(
                f"pages {sorted(overlap)} both live and free")
        live = int(np.count_nonzero(refs > 0))
        if live + len(free) != self.num_pages:
            raise PageAliasError(
                f"page leak: {live} live + {len(free)} free != "
                f"{self.num_pages} total")

    def assert_all_free(self) -> None:
        """Teardown leak audit: with no request live, every page is free."""
        self.check_no_aliasing()
        held = np.flatnonzero(self._n_pages > 0)
        if held.size:
            raise PageLeakError(
                f"slots {held.tolist()} still hold mappings at teardown")
        live = np.flatnonzero(self.refcount > 0)
        if live.size:
            raise PageLeakError(
                f"pages {live.tolist()} kept nonzero refcounts at teardown")
        if len(self._free) != self.num_pages:
            raise PageLeakError(f"{len(self._free)} free != "
                                f"{self.num_pages} pages at teardown")
