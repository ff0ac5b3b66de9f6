"""Priority classes, preemption and parking in the port against the JAX
package's ``tests/test_priority.py`` scenarios, on the CPU.

Held here:

- the class-aware scheduler (strict priority across classes and FCFS
  inside one, batch aging, the admission floor, the per-class depth and
  token counters, ``head`` and ``snapshot``) pops, peeks and counts what
  JAX's ``FCFSScheduler`` does over the same operations;
- a park releases the slot and its private pages (shared prefix pages
  outlive it, refcounted, and the co-tenant sharing them keeps serving
  token-exact), a parked request cancels and expires with its tokens, and
  the engine never preempts on its own without a resume consumer;
- an interactive head blocked on slots parks the lowest-class slot; under
  the supervisor the parked request resumes TOKEN-EXACT — greedy and
  sampled, paged and flat — equal to the JAX supervisor's tokens and to
  the request served alone, with the ``requests_preempted`` /
  ``requests_resumed`` counters equal to JAX's.

The JAX side runs its plain (non-Pallas) path, pinned per test.
"""

import jax
import numpy as np
import pytest

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.ops import _support as jax_support
from apex_tpu.serving import EngineConfig as JaxEngineConfig
from apex_tpu.serving import EngineSupervisor as JaxSupervisor
from apex_tpu.serving import FCFSScheduler as JaxScheduler
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import SamplingParams as JaxSampling
from apex_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from apex_tpu_torch.convert import load_jax_params
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.observability import MetricsRegistry
from apex_tpu_torch.serving import (EngineConfig, EngineSupervisor,
                                    FCFSScheduler, InferenceEngine, Request,
                                    SamplingParams, SchedulerConfig)
from apex_tpu_torch.serving.request import PRIORITIES

SMALL = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
             vocab_size=64, max_position_embeddings=64)
PORT = (Request, SamplingParams, SchedulerConfig, EngineConfig)
JAX = (JaxRequest, JaxSampling, JaxSchedulerConfig, JaxEngineConfig)


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _pair(scale=4.0):
    jm = JaxGPT(JaxConfig(**SMALL, hidden_dropout=0.0,
                          attention_dropout=0.0))
    params = jm.init(jax.random.PRNGKey(0))
    params = dict(params, transformer=jax.tree.map(
        lambda x: x * scale, params["transformer"]))
    tm = GPTModel(TransformerConfig(**SMALL), device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _req(classes, prompt, max_new=4, priority="standard", deadline=None,
         **sampling):
    request_cls, sampling_cls = classes[:2]
    return request_cls(prompt=list(prompt), max_new_tokens=max_new,
                       sampling=sampling_cls(priority=priority, **sampling),
                       deadline_s=deadline)


def _scheduler_walk(classes, scheduler_cls):
    """One op script through a scheduler; returns what it popped, peeked
    and counted, by request index."""
    sched = scheduler_cls(classes[2](max_queue=16, batch_aging_s=5.0))
    order = ["batch", "standard", "batch", "interactive", "standard",
             "batch"]
    reqs = [_req(classes, [1] * (i + 2), priority=p)
            for i, p in enumerate(order)]
    index = {r.request_id: i for i, r in enumerate(reqs)}
    for i, r in enumerate(reqs):
        sched.submit(r, now=float(i))
    out = [sched.queued_tokens, sched.queued_tokens_by_class(),
           sched.depth_by_class(),
           [index[r.request_id] for r, _ in sched.snapshot()],
           index[sched.head(now=6.0)[0].request_id],
           # the batch head (t 0) ages to standard rank past 5 s and,
           # older, overtakes the standard heads
           index[sched.head(now=9.0)[0].request_id]]
    sched.set_admission_floor("standard")
    out.append(sched.admission_floor)
    out.append([index[r.request_id]
                for r, _ in sched.pop_admissible(8, False, now=6.0)])
    sched.set_admission_floor(None)
    out.append([index[r.request_id]
                for r, _ in sched.pop_admissible(8, False, now=6.0)])
    with pytest.raises(ValueError, match="priority"):
        sched.set_admission_floor("urgent")
    return out


def test_scheduler_surface_matches_jax():
    got = _scheduler_walk(PORT, FCFSScheduler)
    assert got == _scheduler_walk(JAX, JaxScheduler)
    assert got[6] == "standard" and got[7] == [3, 1, 4]


def _engine(tm, max_slots=2, **knobs):
    return InferenceEngine(tm, EngineConfig(
        max_slots=max_slots, max_len=48, page_size=4,
        scheduler=SchedulerConfig(max_queue=8, max_prefills_per_tick=1),
        **knobs), device="cpu")


@pytest.mark.parametrize("layout", ["paged", "flat"])
def test_park_releases_slot_and_pages_then_cancel_and_expire(
        pair, layout, monkeypatch):
    from apex_tpu_torch.serving import clock
    now = [100.0]
    monkeypatch.setattr(clock, "now", lambda: now[0])
    eng = _engine(pair[2], kv_layout=layout)
    dead = _req(PORT, [1, 2, 3], max_new=30, priority="batch",
                deadline=0.5)
    keep = _req(PORT, [3, 4], max_new=30, priority="batch")
    eng.submit(dead)
    eng.submit(keep)
    eng.tick()          # nothing decodes yet: both admitted, then a step
    assert eng.active_count == 2
    assert eng.queued_depth_by_class() == {p: 0 for p in PRIORITIES}
    assert eng.park_class("batch", cause="test") == 2
    assert eng.active_count == 0 and eng.parked_count == 2
    eng.slots.check()
    if eng.pages is not None:
        assert eng.pages.in_use_count == 0
    assert eng.metrics.counters()["requests_preempted"] == 2
    # cancel while parked: terminal now, with the tokens it had
    assert eng.cancel(keep.request_id)
    res = eng.completed[keep.request_id]
    assert res.finish_reason == "cancelled" and len(res.tokens) == 2
    # the deadline clock runs while parked
    now[0] += 1.0
    (res,) = eng.tick()
    assert (res.request_id, res.finish_reason) == (dead.request_id,
                                                   "timeout")
    assert len(res.tokens) == 2 and eng.parked_count == 0


def test_no_preemption_without_a_resume_consumer(pair):
    eng = _engine(pair[2], max_slots=1)
    assert eng.resume_consumer is False
    eng.submit(_req(PORT, [1, 2], max_new=20, priority="batch"))
    eng.tick()
    eng.submit(_req(PORT, [5], max_new=2, priority="interactive"))
    eng.tick()
    assert eng.parked_count == 0 and eng.queued_count == 1
    eng.resume_consumer = True
    (done,) = eng.tick()          # parks the batch slot, serves the head
    assert eng.parked_count == 1 and done.finish_reason == "length"


def test_shared_prefix_pages_outlive_a_parked_slot(pair):
    """A batch and a standard request share a 2-page prompt prefix;
    parking the standard one (admitted second, a prefix-cache hit) leaves
    the shared pages mapped (refcounted) under the batch one, which keeps
    its un-preempted stream."""
    tm = pair[2]
    prefix = list(range(3, 11))
    first = dict(prompt=prefix + [20, 21], max_new=12)
    second = dict(prompt=prefix + [30], max_new=12)
    alone = _engine(tm).serve([_req(PORT, first["prompt"],
                                    first["max_new"], "batch")])
    eng = _engine(tm)
    a = _req(PORT, first["prompt"], first["max_new"], "batch")
    b = _req(PORT, second["prompt"], second["max_new"], "standard")
    eng.submit(a)
    eng.tick()
    eng.submit(b)
    eng.tick()
    assert eng.metrics.counters()["prefix_hits"] == 1
    slot_b = next(s for s, r in eng._active.items()
                  if r.request is b)
    shared = eng.pages.slot_pages(slot_b)[:2]
    assert eng.park_class("standard") == 1
    slot_a = next(iter(eng._active))
    assert eng.pages.slot_pages(slot_a)[:2] == shared
    eng.pages.check()
    out = eng.serve([])
    assert eng.completed[a.request_id].tokens == alone[0].tokens
    assert out == []


def _serve_with_preempt(make_sup, classes, victim_kw, layout):
    """Run a batch victim until it is mid-decode, then submit an
    interactive head; tick to completion. Returns (victim tokens,
    counters, preempt/resume events)."""
    cfg = classes[3](max_slots=1, max_len=48, page_size=4, kv_layout=layout,
                     scheduler=classes[2](max_queue=8,
                                          max_prefills_per_tick=1))
    sup = make_sup(cfg)
    victim = _req(classes, **victim_kw)
    hi = _req(classes, [7, 2], max_new=2, priority="interactive")
    results = {}
    sup.submit(victim)
    for _ in range(200):
        for res in sup.tick():
            results[res.request_id] = res
        act = sup.engine._active
        if act and len(next(iter(act.values())).tokens) >= 2:
            break
    sup.submit(hi)
    for _ in range(400):
        for res in sup.tick():
            results[res.request_id] = res
        if len(results) == 2:
            break
    sup.close()
    res = results[victim.request_id]
    assert res.finish_reason == "length" and res.priority == "batch"
    assert res.trace_id == victim.trace_id
    counters = sup.metrics.counters()
    return (list(res.tokens), counters["requests_preempted"],
            counters["requests_resumed"])


VICTIMS = {
    "greedy": dict(prompt=[5, 9, 3], max_new=10, priority="batch"),
    "sampled": dict(prompt=[4, 8, 1], max_new=10, priority="batch",
                    temperature=0.9, top_k=8, seed=1234),
}


@pytest.mark.parametrize("layout", ["paged", "flat"])
@pytest.mark.parametrize("kind", list(VICTIMS))
def test_preempted_request_resumes_token_exact(pair, kind, layout):
    jm, params, tm = pair
    got = _serve_with_preempt(
        lambda cfg: EngineSupervisor(tm, cfg, metrics=MetricsRegistry(),
                                     device="cpu"),
        PORT, VICTIMS[kind], layout)
    want = _serve_with_preempt(
        lambda cfg: JaxSupervisor(jm, params, cfg), JAX, VICTIMS[kind],
        layout)
    assert got == want
    assert got[1:] == (1, 1)
    alone = EngineSupervisor(tm, EngineConfig(
        max_slots=1, max_len=48, page_size=4, kv_layout=layout),
        device="cpu").serve([_req(PORT, **VICTIMS[kind])])
    assert got[0] == alone[0].tokens


@pytest.mark.slow
def test_int8_speculative_sampled_resume_matches_jax(pair):
    """The resume cross on int8 pools with speculation 3, sampled."""
    jm, params, tm = pair
    victim = dict(VICTIMS["sampled"], prompt=[6, 2, 9, 6, 2, 9, 6])

    def port(cfg):
        cfg.kv_dtype, cfg.speculation = "int8", 3
        return EngineSupervisor(tm, cfg, device="cpu")

    def ref(cfg):
        cfg.kv_dtype, cfg.speculation = "int8", 3
        return JaxSupervisor(jm, params, cfg)

    assert _serve_with_preempt(port, PORT, victim, "paged") == \
        _serve_with_preempt(ref, JAX, victim, "paged")
