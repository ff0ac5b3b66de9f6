"""Fixed-capacity decode slot pool with free-list allocation.

Adapted from ``apex_tpu/serving/slots.py`` (stdlib only), kept in the
port so it never imports the JAX package.

Each slot is one row of the engine's batched KV cache: a request holds
exactly one slot from prefill to retirement, and the pool's invariant —
every slot is either free or owned by exactly one request — is what the
scheduler tests mean by "no slot leaks". Allocation always hands out
the LOWEST free slot id so runs are deterministic (the same arrival
order always produces the same slot assignment, and therefore the same
decode batch layout).

Under the paged KV layout a slot row does not reserve ``max_len`` cache
memory; each slot maps a variable number of fixed-size pages out of a
shared :class:`PagePool`, and every page is either free or owned by
exactly one slot. The JAX package's pool also refcounts pages shared
through its prefix-intern index; that comes to the port with the
prefix-cache slice.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional

__all__ = ["SlotError", "SlotPool", "PageError", "PagePool"]


class SlotError(RuntimeError):
    """A slot-pool invariant was violated (double release, foreign id)."""


class PageError(RuntimeError):
    """A page-pool invariant was violated (leak, foreign page, double map)."""


class SlotPool:
    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._free: List[int] = list(range(capacity))  # already a heap
        self._active: set = set()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def occupancy(self) -> float:
        """Active fraction in [0, 1] — the slot-occupancy histogram feed."""
        return len(self._active) / self.capacity

    def allocate(self) -> Optional[int]:
        """Lowest free slot id, or None when the pool is exhausted."""
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self._active.add(slot)
        return slot

    def release(self, slot: int) -> None:
        if slot not in self._active:
            raise SlotError(
                f"release of slot {slot} which is not active "
                f"(double release or foreign id; active={sorted(self._active)})")
        self._active.remove(slot)
        heapq.heappush(self._free, slot)

    def reset(self) -> None:
        """Return EVERY slot to the free list — the supervisor's engine
        rebuild / ``close()`` path, where all in-flight occupants are
        being retired at once. Re-asserts the no-leak invariant after
        the rebuild; safe to call on an already-clean pool."""
        self._free = list(range(self.capacity))
        self._active.clear()
        self.check()

    def check(self) -> None:
        """Assert the no-leak invariant; raises :class:`SlotError`."""
        if len(self._free) + len(self._active) != self.capacity or \
                set(self._free) & self._active:
            raise SlotError(
                f"slot leak: {len(self._free)} free + "
                f"{len(self._active)} active != capacity {self.capacity}")


class PagePool:
    """Free-list allocator for the global KV page pool.

    Host-side bookkeeping only — the device pools live in the engine.
    ``n_pages`` pool rows are handed out lowest-first as per-slot page
    lists, in the slot's logical page order. ``pages_per_slot`` bounds
    one slot's list — it is the page-table width, i.e. the paged
    engine's ``max_len`` in pages. Invariant (:meth:`check`): every page
    is on the free heap XOR in exactly one slot's list.
    """

    def __init__(self, n_pages: int, page_size: int, pages_per_slot: int):
        if n_pages < 1 or page_size < 1 or pages_per_slot < 1:
            raise ValueError(
                f"n_pages/page_size/pages_per_slot must be >= 1, got "
                f"{n_pages}/{page_size}/{pages_per_slot}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self._free: List[int] = list(range(n_pages))  # already a heap
        self._owned: Dict[int, List[int]] = {}        # slot -> pages

    # -- introspection ----------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use_count(self) -> int:
        """Slot-mapped pages. ``free + in_use == n_pages`` always."""
        return self.n_pages - len(self._free)

    @property
    def occupancy(self) -> float:
        """Mapped fraction in [0, 1] — the kv_page_occupancy feed."""
        return self.in_use_count / self.n_pages

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` cache rows."""
        return -(-tokens // self.page_size)

    def slot_pages(self, slot: int) -> List[int]:
        """The pages currently mapped to ``slot``, in logical order."""
        return list(self._owned.get(slot, ()))

    # -- slot mapping -----------------------------------------------------

    def _need(self, slot: int, tokens: int) -> int:
        need = self.pages_for(tokens)
        if need > self.pages_per_slot:
            raise PageError(
                f"slot {slot} needs {need} pages > pages_per_slot "
                f"{self.pages_per_slot}")
        return need

    def _take_free(self, k: int) -> Optional[List[int]]:
        """Pop ``k`` pages off the free heap; None (taking nothing) when
        the pool cannot supply them all."""
        if k > len(self._free):
            return None
        return [heapq.heappop(self._free) for _ in range(k)]

    def map_slot(self, slot: int, tokens: int) -> Optional[List[int]]:
        """Map a fresh slot with enough pages for ``tokens`` rows. Returns
        the page list, or None when the pool cannot supply it — the
        caller defers or sheds rather than partially mapping. A slot may
        only be mapped once between releases."""
        if slot in self._owned:
            raise PageError(f"slot {slot} is already mapped")
        fresh = self._take_free(self._need(slot, max(tokens, 1)))
        if fresh is None:
            return None
        self._owned[slot] = fresh
        return list(fresh)

    def extend_slot(self, slot: int, tokens: int) -> Optional[List[int]]:
        """Grow ``slot`` to cover ``tokens`` rows (decode on-demand path).

        Returns the NEWLY mapped pages (possibly empty), or None when the
        pool is exhausted — the slot keeps its existing pages and the
        caller decides whether to retire it.
        """
        if slot not in self._owned:
            raise PageError(f"extend of unmapped slot {slot}")
        grow = self._need(slot, tokens) - len(self._owned[slot])
        if grow <= 0:
            return []
        fresh = self._take_free(grow)
        if fresh is None:
            return None
        self._owned[slot].extend(fresh)
        return fresh

    def release_slot(self, slot: int) -> List[int]:
        """Return ``slot``'s pages to the free heap; returns them (the
        quarantine scrub zeroes exactly these rows)."""
        if slot not in self._owned:
            raise PageError(
                f"release of unmapped slot {slot} "
                f"(double release or foreign id; "
                f"mapped={sorted(self._owned)})")
        freed = self._owned.pop(slot)
        for p in freed:
            heapq.heappush(self._free, p)
        return freed

    def reset(self) -> None:
        """Return EVERY page to the free heap — the engine's close path,
        mirroring :meth:`SlotPool.reset`."""
        self._free = list(range(self.n_pages))
        self._owned.clear()
        self.check()

    def check(self) -> None:
        """Assert the one-owner invariant; raises :class:`PageError`:
        the free heap and the slot lists partition ``n_pages`` exactly,
        and no slot exceeds ``pages_per_slot``."""
        owned = [p for pages in self._owned.values() for p in pages]
        for p in owned:
            if not 0 <= p < self.n_pages:
                raise PageError(f"foreign page id {p} "
                                f"(pool has 0..{self.n_pages - 1})")
        if sorted(owned + self._free) != list(range(self.n_pages)):
            raise PageError(
                f"page leak: {len(self._free)} free + {len(owned)} mapped "
                f"!= n_pages {self.n_pages} (or a page is held twice)")
        for slot, pages in self._owned.items():
            if len(pages) > self.pages_per_slot:
                raise PageError(
                    f"slot {slot} maps {len(pages)} pages > "
                    f"pages_per_slot {self.pages_per_slot}")
