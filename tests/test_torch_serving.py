"""The port's serving bookkeeping on its own (no JAX side): the one-owner
page pool, cancellation, and quarantine of a poisoned slot, on the CPU
with a tiny f32 model."""

import math

import numpy as np
import pytest
import torch

from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.serving import (
    EngineConfig,
    InferenceEngine,
    PageError,
    PagePool,
    Request,
)

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64)


@pytest.fixture(scope="module")
def model():
    return GPTModel(TransformerConfig(**TINY), device="cpu",
                    generator=torch.Generator().manual_seed(0))


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(0, 128, size=n).tolist()


def test_page_pool_is_lowest_first_and_all_or_nothing():
    pool = PagePool(n_pages=6, page_size=4, pages_per_slot=3)
    assert pool.map_slot(0, 5) == [0, 1]
    assert pool.map_slot(1, 9) == [2, 3, 4]
    assert pool.map_slot(2, 8) is None            # 2 needed, 1 free
    assert pool.free_count == 1 and pool.in_use_count == 5
    assert pool.extend_slot(0, 8) == []            # still two pages
    assert pool.extend_slot(0, 9) == [5]
    assert pool.extend_slot(1, 12) == []
    with pytest.raises(PageError, match="pages_per_slot"):
        pool.extend_slot(1, 13)
    assert pool.release_slot(1) == [2, 3, 4]
    pool.check()
    with pytest.raises(PageError, match="unmapped"):
        pool.release_slot(1)
    assert pool.map_slot(1, 1) == [2]
    pool._owned[1].append(0)                       # a page held twice
    # the refcounted pool counts one reference too few for page 0
    with pytest.raises(PageError, match="refcount drift"):
        pool.check()


def test_cancel_queued_and_in_flight(model):
    eng = InferenceEngine(model, EngineConfig(max_slots=1, max_len=32,
                                              page_size=8), device="cpu")
    running = Request(prompt=_prompt(5, 1), max_new_tokens=10)
    queued = Request(prompt=_prompt(6, 2), max_new_tokens=10)
    eng.submit(running)
    eng.submit(queued)
    eng.tick()                                     # running is prefilled
    assert eng.cancel(queued.request_id)
    assert eng.completed[queued.request_id].finish_reason == "cancelled"
    assert eng.cancel(running.request_id)
    eng.tick()
    res = eng.completed[running.request_id]
    assert res.finish_reason == "cancelled" and 1 <= len(res.tokens) < 10
    assert eng.pages.free_count == eng.pages.n_pages
    assert not eng.cancel(12345)


def test_poisoned_slot_is_quarantined_and_scrubbed(model):
    # the one-owner pool: with the prefix cache on, the victim's interned
    # prompt page would outlive it (interned pages are never written
    # after their finite prefill, so the poisoning here could not reach
    # one in serving)
    cfg = EngineConfig(max_slots=2, max_len=32, page_size=8,
                       prefix_cache=False)
    healthy = dict(prompt=_prompt(7, 4), max_new_tokens=8)
    solo = InferenceEngine(model, cfg, device="cpu").serve(
        [Request(**healthy)])[0].tokens

    eng = InferenceEngine(model, cfg, device="cpu")
    victim = Request(prompt=_prompt(9, 3), max_new_tokens=8)
    poisoned = []

    def poison(engine, tick):
        # after the first tick both slots are decoding: NaN the victim's
        # K pages, so its next decode step has non-finite logits
        if tick == 1:
            pages = engine.pages.slot_pages(0)
            for k, _ in engine._caches:
                k[pages] = math.nan
            poisoned.extend(pages)

    res = eng.serve([victim, Request(**healthy)], on_tick=poison)
    assert res[0].finish_reason == "error"
    assert res[1].finish_reason == "length" and res[1].tokens == solo
    assert eng.metrics.counters()["slots_quarantined"] == 1
    assert eng.pages.free_count == eng.pages.n_pages
    eng.pages.check()
    for k, v in eng._caches:                      # the scrub zeroed them
        assert not k[poisoned].any() and not v[poisoned].any()


def test_bf16_engine_leaves_the_callers_model_alone():
    cfg = TransformerConfig(**TINY, compute_dtype=torch.bfloat16)
    fp32 = GPTModel(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    before = {n: p.clone() for n, p in fp32.named_parameters()}
    eng = InferenceEngine(fp32, EngineConfig(max_slots=1, max_len=32,
                                             page_size=8), device="cpu")
    res = eng.serve([Request(prompt=_prompt(5, 1), max_new_tokens=3)])
    assert res[0].finish_reason == "length" and len(res[0].tokens) == 3
    for n, p in fp32.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, before[n]), n
    cast = dict(eng.model.named_parameters())
    assert eng.model is not fp32 and cast.keys() == before.keys()
    for n, p in cast.items():
        assert p.dtype == torch.bfloat16, n
        assert torch.equal(p, before[n].to(torch.bfloat16)), n
