"""The port's prefix-cache bookkeeping against the JAX package's, on the
host: the prompt-prefix hash chains, the n-gram drafter, and the
refcounted ``PagePool`` with its intern index and LRU bound.

The same seeded sequence of pool operations (map with and without a
shared prefix, extend, intern, match, release, scrub, reset) runs on
``apex_tpu.serving.slots.PagePool`` and on the port's; every return value
and every count must be equal after each step, and both pools' ``check()``
(refcount conservation, and the zero-scale invariant of scrubbed free
pages) must hold throughout.
"""

import numpy as np
import pytest
import torch

from apex_tpu.serving import prefix as jprefix
from apex_tpu.serving import speculation as jspec
from apex_tpu.serving.slots import PageError as JaxPageError
from apex_tpu.serving.slots import PagePool as JaxPagePool
from apex_tpu_torch.serving import prefix, speculation
from apex_tpu_torch.serving.slots import PageError, PagePool


@pytest.mark.parametrize("page_size", [1, 4, 7])
def test_hash_chains_match_jax(page_size):
    rng = np.random.RandomState(page_size)
    for n in (0, 3, 16, 29):
        tokens = rng.randint(0, 50000, size=n).tolist()
        for salt in ("", "2:64:4:2:128:learned"):
            assert prefix.prefix_hash_chain(tokens, page_size, salt) == \
                jprefix.prefix_hash_chain(tokens, page_size, salt)
    a = prefix.prefix_hash_chain(list(range(20)), 4)
    b = prefix.prefix_hash_chain(list(range(10)) + [99] * 10, 4)
    assert prefix.common_chain_len(a, b) == 2 == \
        jprefix.common_chain_len(a, b)
    assert prefix.adapter_salt("s", "t") == jprefix.adapter_salt("s", "t")


def test_drafts_match_jax():
    rng = np.random.RandomState(0)
    for n in (0, 1, 5, 40, 300):
        period = rng.randint(0, 9, size=rng.randint(1, 6)).tolist()
        ctx = (period * 80)[:n]
        for k in (0, 1, 3):
            assert speculation.propose_draft(ctx, k) == \
                jspec.propose_draft(ctx, k)


def _state(pool, slots):
    return (pool.free_count, pool.in_use_count, pool.owned_count,
            pool.reclaimable_count, pool.interned_count, pool.evictions,
            pool.occupancy,
            [(pool.slot_pages(s), pool.shared_pages(s)) for s in slots])


def _call(pool, name, *args):
    """``pool.name(*args)``, or the name of the page error it raised."""
    try:
        out = getattr(pool, name)(*args)
    except (PageError, JaxPageError) as err:
        return type(err).__name__
    return list(out) if isinstance(out, (list, tuple)) else out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("capacity", [0, 2, 5])
def test_page_pool_matches_jax(seed, capacity):
    """A seeded random walk of pool operations under pressure (10 pages
    for 4 slots of up to 4 pages): same returns, same counts, both
    ``check()``s hold after every step."""
    rng = np.random.RandomState(seed)
    ps, n_pages, pps, n_slots = 4, 10, 4, 4
    pools = [JaxPagePool(n_pages, ps, pps, lru_capacity=capacity),
             PagePool(n_pages, ps, pps, lru_capacity=capacity)]
    prompts = [rng.randint(0, 5, size=12).tolist() for _ in range(3)]
    chains = {}
    scales = np.zeros((n_pages, 2), np.float32)
    for step in range(120):
        op = rng.randint(6)
        slot = int(rng.randint(n_slots))
        mapped = slot in pools[0]._owned
        if op <= 1 and not mapped:
            p = prompts[rng.randint(3)][:int(rng.randint(1, 13))]
            chain = jprefix.prefix_hash_chain(p, ps)
            assert chain == prefix.prefix_hash_chain(p, ps)
            matches = [_call(pool, "match_prefix", chain) for pool in pools]
            assert matches[0] == matches[1]
            shared = matches[0][0] if rng.rand() < 0.8 else []
            outs = [_call(pool, "map_slot", slot, len(p), shared)
                    for pool in pools]
            assert outs[0] == outs[1]
            if isinstance(outs[0], list):
                chains[slot] = (chain, outs[0])
        elif op == 2 and mapped:
            grow = int(rng.randint(1, 3 * ps))
            have = len(pools[0].slot_pages(slot)) * ps
            outs = [_call(pool, "extend_slot", slot, have + grow)
                    for pool in pools]
            assert outs[0] == outs[1]
        elif op == 3 and slot in chains:
            chain, pages = chains[slot]
            outs = [_call(pool, "intern_prefix", chain, pages[:len(chain)])
                    for pool in pools]
            assert outs[0] == outs[1]
        elif op == 4 and mapped:
            outs = [_call(pool, "release_slot", slot) for pool in pools]
            assert outs[0] == outs[1]
            chains.pop(slot, None)
            if rng.rand() < 0.5 and isinstance(outs[0], list):
                # the quarantine scrub: zeroed pages and scales
                scales[outs[0]] = 0.0
                for pool in pools:
                    pool.note_scrubbed(outs[0])
        elif op == 5 and rng.rand() < 0.1:
            for pool in pools:
                pool.reset()
            chains.clear()
        slots = range(n_slots)
        assert _state(pools[0], slots) == _state(pools[1], slots), step
        pools[0].check(scales, scales)
        pools[1].check(torch.from_numpy(scales), torch.from_numpy(scales))
    # a scrubbed free page whose scale is not zero breaks the invariant
    free = [p for p in range(n_pages) if p in pools[1]._scrubbed]
    if free:
        bad = scales.copy()
        bad[free[0]] = 1.0
        with pytest.raises(PageError, match="scales"):
            pools[1].check(bad, None)


def test_page_pool_shares_and_evicts_like_jax():
    """The prefix lifecycle spelled out: a writer interns its prompt, a
    reader maps the shared run refcounted, the writer's release frees
    only its private pages, the entry keeps the prefix reclaimable, and
    allocation pressure evicts it LRU-first."""
    for cls in (JaxPagePool, PagePool):
        pool = cls(6, 4, 3, lru_capacity=2)
        chain = prefix.prefix_hash_chain(list(range(8)), 4)
        pages = pool.map_slot(0, 10)
        assert pool.intern_prefix(chain, pages[:2])
        got, matched = pool.match_prefix(chain)
        assert (got, matched) == (pages[:2], 2)
        assert pool.map_slot(1, 9, shared=got) == pages[:2] + [3]
        assert pool.release_slot(0) == [2]
        assert pool.release_slot(1) == [3]
        assert (pool.free_count, pool.reclaimable_count,
                pool.interned_count) == (4, 2, 1)
        assert pool.map_slot(2, 12) is not None        # 3 of 4 free
        assert pool.map_slot(3, 12) is not None        # evicts the entry
        assert (pool.evictions, pool.interned_count) == (1, 0)
        pool.check()
