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
shared :class:`PagePool`. Pages are REFCOUNTED: a page may back the shared
prompt prefix of many slots at once, so the one-owner invariant
generalizes to refcount conservation — every page is either on the free
heap or carries exactly as many references as slot mappings plus
intern-index entries that hold it, and it returns to the heap only when
the count reaches zero. A content-addressed intern index
(:meth:`PagePool.intern_prefix` / :meth:`PagePool.match_prefix`) keeps
page-aligned prompt prefixes resident after their writer retires; an LRU
over the interned entries bounds the index and is evicted under
allocation pressure instead of shedding. :meth:`PagePool.check` asserts
the full conservation invariant.
"""

from __future__ import annotations

import heapq
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

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
    """Refcounted free-list allocator for the global KV page pool.

    Host-side bookkeeping only — the device arrays live in the engine.
    ``n_pages`` pool rows are handed out lowest-first as per-slot page
    lists; a slot's logical page order is its SHARED prefix pages (mapped
    read-only from the intern index) followed by its PRIVATE pages (fresh
    write targets for the suffix and decode tail). ``pages_per_slot``
    bounds one slot's list — it is the page-table width, i.e. the paged
    engine's ``max_len`` in pages.

    ``lru_capacity`` sizes the prefix-intern index (entries, not pages);
    0 disables interning entirely, which restores the one-owner
    behavior bit-for-bit (``prefix_cache=False``). The conservation
    invariant either way: every page is on the free heap XOR its
    refcount equals its slot-list memberships plus intern-entry
    memberships (:meth:`check`).
    """

    def __init__(self, n_pages: int, page_size: int, pages_per_slot: int,
                 lru_capacity: int = 0):
        if n_pages < 1 or page_size < 1 or pages_per_slot < 1:
            raise ValueError(
                f"n_pages/page_size/pages_per_slot must be >= 1, got "
                f"{n_pages}/{page_size}/{pages_per_slot}")
        if lru_capacity < 0:
            raise ValueError(
                f"lru_capacity must be >= 0, got {lru_capacity}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.lru_capacity = lru_capacity
        self._free: List[int] = list(range(n_pages))  # already a heap
        self._refs: Dict[int, int] = {}               # page -> refcount
        self._shared: Dict[int, List[int]] = {}       # slot -> prefix pages
        self._owned: Dict[int, List[int]] = {}        # slot -> private pages
        #: chain -> pages, oldest-first (LRU order; move_to_end on touch)
        self._interned: "OrderedDict[Tuple[int, ...], List[int]]" = \
            OrderedDict()
        #: cumulative intern-entry evictions (capacity + pressure) — the
        #: engine snapshots deltas into its ``prefix_evictions`` counter
        self.evictions = 0
        #: free pages the engine's quarantine scrub has zeroed (content
        #: AND, on quantized pools, the scale sidecar) — tracked so
        #: :meth:`check` can assert the zero-scale invariant on them;
        #: membership ends at the page's next allocation
        self._scrubbed: set = set()

    # -- introspection ----------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use_count(self) -> int:
        """Referenced pages: slot-mapped or kept alive by the intern
        index. ``free + in_use == n_pages`` always."""
        return self.n_pages - len(self._free)

    @property
    def owned_count(self) -> int:
        """Private (write-target) pages across all slots — the pages the
        reservation ledger already paid for."""
        return sum(len(v) for v in self._owned.values())

    @property
    def reclaimable_count(self) -> int:
        """Referenced pages held ONLY by intern entries: dropping every
        entry would free exactly this many — the admission predicate's
        extra headroom on top of ``free_count``."""
        slot_held = set()
        for pages in self._shared.values():
            slot_held.update(pages)
        for pages in self._owned.values():
            slot_held.update(pages)
        return sum(1 for p in self._refs if p not in slot_held)

    @property
    def interned_count(self) -> int:
        """Entries currently in the intern index."""
        return len(self._interned)

    @property
    def occupancy(self) -> float:
        """Referenced fraction in [0, 1] — the kv_page_occupancy feed."""
        return self.in_use_count / self.n_pages

    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` cache rows."""
        return -(-tokens // self.page_size)

    def slot_pages(self, slot: int) -> List[int]:
        """The pages currently mapped to ``slot`` (logical order:
        shared prefix first, then private)."""
        return list(self._shared.get(slot, ())) + \
            list(self._owned.get(slot, ()))

    def shared_pages(self, slot: int) -> List[int]:
        """Just the shared prefix pages of ``slot``."""
        return list(self._shared.get(slot, ()))

    # -- the prefix-intern index ------------------------------------------

    def match_prefix(self, chain: Sequence[int]) -> Tuple[List[int], int]:
        """Longest interned leading run of ``chain``: returns
        ``(pages, matched)`` where ``pages`` back tokens
        ``[0, matched * page_size)``. Touches the matched entry's LRU
        position. ``([], 0)`` on a miss (or when interning is off)."""
        best_key, best = None, 0
        for key in self._interned:
            n = 0
            for a, b in zip(key, chain):
                if a != b:
                    break
                n += 1
            if n > best:
                best_key, best = key, n
        if best_key is None:
            return [], 0
        self._interned.move_to_end(best_key)
        return list(self._interned[best_key][:best]), best

    def intern_prefix(self, chain: Sequence[int],
                      pages: Sequence[int]) -> bool:
        """Publish ``pages`` (one per chain entry, already referenced by
        their writer slot) as the immutable backing of ``chain``. Each
        page gains one reference held by the entry, so the prefix
        outlives the writer's retirement. A shorter entry this one
        extends (same leading pages) is upgraded away; at
        ``lru_capacity`` the LRU entry is evicted. Returns True when a
        new entry was created (False: duplicate, or interning off)."""
        if self.lru_capacity <= 0 or not chain:
            return False
        key = tuple(int(h) for h in chain)
        pages = list(pages)
        if len(pages) != len(key):
            raise PageError(
                f"intern chain has {len(key)} entries but {len(pages)} "
                f"pages — one full page per chain entry")
        if key in self._interned:
            self._interned.move_to_end(key)
            return False
        for p in pages:
            if self._refs.get(p, 0) < 1:
                raise PageError(
                    f"intern of unreferenced page {p} — prefixes are "
                    f"published from a LIVE slot's mapping")
        subsumed = [k for k in self._interned
                    if len(k) < len(key) and key[:len(k)] == k
                    and self._interned[k] == pages[:len(k)]]
        for k in subsumed:
            self._drop_entry(k)     # upgrade, not an eviction
        while len(self._interned) >= self.lru_capacity:
            self._drop_entry(next(iter(self._interned)))
            self.evictions += 1
        for p in pages:
            self._refs[p] += 1
        self._interned[key] = pages
        return True

    def _drop_entry(self, key: Tuple[int, ...]) -> int:
        """Remove one intern entry, freeing pages whose last reference
        it held; returns the number of pages freed."""
        freed = 0
        for p in self._interned.pop(key):
            if self._unref(p):
                freed += 1
        return freed

    def _unref(self, p: int) -> bool:
        """Drop one reference; freelists (and reports True) at zero."""
        r = self._refs[p] - 1
        if r:
            self._refs[p] = r
            return False
        del self._refs[p]
        heapq.heappush(self._free, p)
        return True

    def _take_free(self, k: int) -> Optional[List[int]]:
        """Pop ``k`` pages off the free heap, evicting intern entries
        (oldest-first, only ones that actually free pages) under
        pressure. None when the pool genuinely cannot supply them —
        all-or-nothing, no partial allocation."""
        while k > len(self._free):
            victim = None
            for key in self._interned:   # oldest-first
                if any(self._refs.get(p, 0) == 1
                       for p in self._interned[key]):
                    victim = key
                    break
            if victim is None:
                return None
            self._drop_entry(victim)
            self.evictions += 1
        pages = [heapq.heappop(self._free) for _ in range(k)]
        for p in pages:
            self._refs[p] = self._refs.get(p, 0) + 1
            self._scrubbed.discard(p)   # allocated: may be written again
        return pages

    # -- slot mapping -----------------------------------------------------

    def map_slot(self, slot: int, tokens: int,
                 shared: Optional[Sequence[int]] = None
                 ) -> Optional[List[int]]:
        """Map a fresh slot with enough pages for ``tokens`` rows.

        ``shared`` (from :meth:`match_prefix`) maps those pages as the
        slot's read-only prefix — they gain a reference instead of
        leaving the free heap — and only the remainder is allocated
        privately. Returns the full page list (logical order), or None
        when the pool cannot supply the private remainder even after
        evicting reclaimable intern entries — the caller defers or sheds
        rather than partially mapping (all-or-None holds WITH a hit: a
        hit whose private remainder cannot fit maps nothing). A slot may
        only be mapped once between releases.
        """
        if slot in self._owned:
            raise PageError(f"slot {slot} is already mapped")
        shared = list(shared) if shared else []
        need = self.pages_for(max(tokens, 1))
        if need > self.pages_per_slot:
            raise PageError(
                f"slot {slot} needs {need} pages > pages_per_slot "
                f"{self.pages_per_slot}")
        if len(shared) > need:
            raise PageError(
                f"slot {slot}: shared prefix ({len(shared)} pages) "
                f"exceeds the {need}-page mapping")
        for p in shared:
            if self._refs.get(p, 0) < 1:
                raise PageError(
                    f"shared page {p} is unreferenced — stale "
                    f"match_prefix result?")
        # pin the shared run FIRST so pressure eviction inside the
        # private allocation can never free the pages we are mapping
        for p in shared:
            self._refs[p] += 1
        fresh = self._take_free(need - len(shared))
        if fresh is None:
            for p in shared:
                self._unref(p)      # roll back: all-or-None
            return None
        self._shared[slot] = shared
        self._owned[slot] = fresh
        return shared + fresh

    def extend_slot(self, slot: int, tokens: int) -> Optional[List[int]]:
        """Grow ``slot`` to cover ``tokens`` rows (decode on-demand path).

        Returns the NEWLY mapped private pages (possibly empty), or None
        when the pool is exhausted even after evicting reclaimable
        intern entries — the slot keeps its existing pages and the
        caller decides whether to retire it.
        """
        if slot not in self._owned:
            raise PageError(f"extend of unmapped slot {slot}")
        have = len(self._shared.get(slot, ())) + len(self._owned[slot])
        need = self.pages_for(tokens)
        if need > self.pages_per_slot:
            raise PageError(
                f"slot {slot} needs {need} pages > pages_per_slot "
                f"{self.pages_per_slot}")
        grow = need - have
        if grow <= 0:
            return []
        fresh = self._take_free(grow)
        if fresh is None:
            return None
        self._owned[slot].extend(fresh)
        return fresh

    def note_scrubbed(self, pages: Sequence[int]) -> None:
        """Record that the engine zeroed these FREE pages (quarantine
        hygiene). On quantized pools the scrub also zeroes the scale
        sidecar, and :meth:`check` asserts that stays true until the
        page is allocated again."""
        for p in pages:
            if p in self._refs:
                raise PageError(
                    f"scrub of referenced page {p} — the scrub program "
                    f"must only touch pages whose last reference dropped")
            self._scrubbed.add(p)

    def release_slot(self, slot: int) -> List[int]:
        """Drop all of ``slot``'s references; returns the pages whose
        LAST reference this release dropped (now back on the free heap —
        the scrub path zeroes exactly these rows). Shared pages still
        held by co-tenant slots or the intern index stay mapped and are
        NOT in the returned list."""
        if slot not in self._owned:
            raise PageError(
                f"release of unmapped slot {slot} "
                f"(double release or foreign id; "
                f"mapped={sorted(self._owned)})")
        freed = []
        for p in self._shared.pop(slot, []) + self._owned.pop(slot):
            if self._unref(p):
                freed.append(p)
        return freed

    def reset(self) -> None:
        """Return EVERY page to the free heap AND clear the prefix-intern
        index + LRU — engine rebuild/close path, mirroring
        :meth:`SlotPool.reset`. A rebuilt engine must start from a full
        pool with an empty index (recovery never assumes residency)."""
        self._free = list(range(self.n_pages))
        self._refs.clear()
        self._shared.clear()
        self._owned.clear()
        self._interned.clear()
        self._scrubbed.clear()
        self.check()

    def check(self, k_scales=None, v_scales=None) -> None:
        """Assert refcount conservation; raises :class:`PageError`.

        Every page's refcount must equal its slot-list memberships plus
        intern-entry memberships; the free heap and the referenced set
        partition ``n_pages`` exactly; no slot maps a page twice or
        exceeds ``pages_per_slot``. With a quantized pool's scale
        sidecars (``k_scales``/``v_scales``, ``[n_pages, kv_heads]``
        arrays or tensors — pass one layer's), additionally asserts every
        page the scrub zeroed (:meth:`note_scrubbed`) still carries
        all-zero scales while free — the invariant that keeps a recycled
        page's rescale floor clean."""
        for name, scales in (("k", k_scales), ("v", v_scales)):
            if scales is None:
                continue
            if hasattr(scales, "detach"):
                scales = scales.detach().cpu()
            sc = np.asarray(scales)
            if sc.shape[0] != self.n_pages:
                raise PageError(
                    f"{name}_scales has {sc.shape[0]} rows, pool has "
                    f"{self.n_pages} pages")
            stale = [p for p in sorted(self._scrubbed)
                     if p not in self._refs and sc[p].any()]
            if stale:
                raise PageError(
                    f"scrubbed free pages carry nonzero {name} scales: "
                    f"{stale[:8]} — scrub/reset must zero the sidecar")
        expect: Dict[int, int] = {}
        holders = list(self._shared.values()) + list(self._owned.values()) \
            + list(self._interned.values())
        for pages in holders:
            for p in pages:
                if not 0 <= p < self.n_pages:
                    raise PageError(f"foreign page id {p} "
                                    f"(pool has 0..{self.n_pages - 1})")
                expect[p] = expect.get(p, 0) + 1
        if expect != self._refs:
            bad = {p: (self._refs.get(p), expect.get(p))
                   for p in set(expect) | set(self._refs)
                   if self._refs.get(p) != expect.get(p)}
            raise PageError(
                f"refcount drift (page: (recorded, actual)): {bad}")
        free_set = set(self._free)
        if len(free_set) != len(self._free) or free_set & set(expect) or \
                len(self._free) + len(expect) != self.n_pages:
            raise PageError(
                f"page leak: {len(self._free)} free + {len(expect)} "
                f"referenced != n_pages {self.n_pages} (or a page is "
                f"both free and referenced)")
        for slot in set(self._shared) | set(self._owned):
            pages = self.slot_pages(slot)
            if len(set(pages)) != len(pages):
                raise PageError(f"slot {slot} maps a page twice: {pages}")
            if len(pages) > self.pages_per_slot:
                raise PageError(
                    f"slot {slot} maps {len(pages)} pages > "
                    f"pages_per_slot {self.pages_per_slot}")
