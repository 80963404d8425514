"""Paged KV-cache bookkeeping: page pool, free list, per-slot tables.

The port's own copy of ``repro/serving/kv_pages.py`` (pure numpy; the
port imports nothing of the reference), kept identical in behaviour so a
fixed admit/evict schedule gives both packages the same tables.

This module is pure allocator state — no tensors, no model.  The tensor
pools (one (n_periods·(n_pages+1), page_size, H·D) pool per attention
sub-layer position) live in ``engine.ServingGateway``; every layer of
every period shares ONE page table per slot, because a request's token
``t`` occupies the same page/offset in every layer's pool (the
head-interleaved fusion idiom: one allocation decision covers the whole
stack).  Keeping the allocator separate lets property tests sweep
admit/evict schedules without a model.

Invariants (property-tested):

* a page is owned by at most one slot at a time (never double-allocated);
* ``len(free) + Σ owned == n_pages`` always (never leaked, never
  conjured);
* a slot's reservation is returned *in full* on ``free()`` — eviction
  cannot strand pages;
* allocation order is deterministic: the free list is LIFO, so a fixed
  admit/evict schedule reproduces the same physical page assignment
  bit-for-bit (the gateway's determinism gate rests on this).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PageConfig", "PagedKVPool"]


@dataclasses.dataclass(frozen=True)
class PageConfig:
    """Static paged-KV geometry for one gateway."""

    page_size: int = 8           # tokens per page
    n_pages: int = 64            # physical pages in the shared pool
    max_pages_per_slot: int = 8  # page-table length (S_max = this · page_size)

    @property
    def max_tokens_per_slot(self) -> int:
        return self.page_size * self.max_pages_per_slot

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache positions."""
        return -(-max(0, n_tokens) // self.page_size)


class PagedKVPool:
    """Free-list page allocator with per-slot page tables.

    ``table`` keeps unallocated entries at 0 — a *valid* physical page
    id — so the gather kernel can assemble every slot unconditionally;
    positions beyond a slot's length are masked by attention, never
    read as data.
    """

    def __init__(self, cfg: PageConfig, n_slots: int):
        self.cfg = cfg
        self.n_slots = n_slots
        # LIFO free list, low ids on top: deterministic reuse order
        self._free = list(range(cfg.n_pages - 1, -1, -1))
        self._owned: list[list[int]] = [[] for _ in range(n_slots)]
        self.table = np.zeros((n_slots, cfg.max_pages_per_slot), np.int32)
        self.lens = np.zeros((n_slots,), np.int32)

    # -- capacity ------------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return sum(len(o) for o in self._owned)

    def can_reserve(self, n_tokens: int) -> bool:
        need = self.cfg.pages_for(n_tokens)
        return (need <= len(self._free)
                and need <= self.cfg.max_pages_per_slot)

    # -- slot lifecycle ------------------------------------------------------

    def reserve(self, slot: int, n_tokens: int) -> None:
        """Allocate a slot's whole-lifetime page reservation up front."""
        if self._owned[slot]:
            raise RuntimeError(f"slot {slot} already holds a reservation")
        need = self.cfg.pages_for(n_tokens)
        if need > self.cfg.max_pages_per_slot:
            raise ValueError(
                f"request needs {need} pages > table length "
                f"{self.cfg.max_pages_per_slot}")
        if need > len(self._free):
            raise RuntimeError(
                f"pool exhausted: need {need}, free {len(self._free)}")
        pages = [self._free.pop() for _ in range(need)]
        self._owned[slot] = pages
        self.table[slot, :] = 0
        self.table[slot, :need] = pages
        self.lens[slot] = 0

    def free(self, slot: int) -> None:
        """Return the slot's reservation to the free list (reverse
        order, so a LIFO realloc of the same size reuses the same
        pages — deterministic)."""
        for pid in reversed(self._owned[slot]):
            self._free.append(pid)
        self._owned[slot] = []
        self.table[slot, :] = 0
        self.lens[slot] = 0

    # -- per-step write positions --------------------------------------------

    def write_pos(self, slot: int) -> tuple[int, int]:
        """(page_id, offset) where the slot's next token row lands."""
        ln = int(self.lens[slot])
        j, off = divmod(ln, self.cfg.page_size)
        if j >= len(self._owned[slot]):
            raise RuntimeError(
                f"slot {slot} writing past its reservation "
                f"(len {ln}, {len(self._owned[slot])} pages)")
        return int(self.table[slot, j]), off

    def write_span(self, slot: int, n: int) -> np.ndarray:
        """(n, 2) int32 ``(page_id, offset)`` rows for the slot's next
        ``n`` consecutive cache positions — the chunked-prefill write
        path.  A chunk that crosses one or more page boundaries is
        split here, host-side, against the slot's page table; the
        flattened row list feeds ONE aliased multi-row scatter
        (``kernels.paged_scatter_rows``)."""
        ln = int(self.lens[slot])
        pos = ln + np.arange(n)
        j = pos // self.cfg.page_size
        if n and j[-1] >= len(self._owned[slot]):
            raise RuntimeError(
                f"slot {slot} writing past its reservation "
                f"(len {ln} + {n}, {len(self._owned[slot])} pages)")
        return np.stack([self.table[slot, j],
                         pos % self.cfg.page_size], axis=1).astype(np.int32)

    def advance(self, slot: int, n: int = 1) -> None:
        self.lens[slot] += n

    # -- audits (property tests) ---------------------------------------------

    def check_invariants(self) -> None:
        seen: set[int] = set()
        for slot, owned in enumerate(self._owned):
            for pid in owned:
                if pid in seen:
                    raise AssertionError(f"page {pid} double-allocated")
                seen.add(pid)
        if seen & set(self._free):
            raise AssertionError("page simultaneously owned and free")
        total = len(self._free) + len(seen)
        if total != self.cfg.n_pages:
            raise AssertionError(
                f"page leak: {total} accounted != {self.cfg.n_pages}")
