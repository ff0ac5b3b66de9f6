"""The port's Multi-LoRA against the JAX package's, on the CPU.

Both packages get the same converted weights (the tiny GPT of
``tests/test_lora.py``: 2 layers, hidden 32, 4 heads, vocab 64, its
transformer weights scaled up so that greedy streams vary) and the same
converted adapters (``random_adapter`` with ``PRNGKey(i + 1)``, scale
0.05, as ``tests/test_lora.py`` draws them). Held here:

- ``AdapterStore``: bank shapes, the null row, the lifecycle (indices,
  in-place overwrite, unload, reuse, a full bank) and every error type and
  message equal JAX's, the banks equal after every step;
- ``merge_adapter``: bitwise JAX's in bf16, within 1 fp32 ulp in f32;
  ``_lora_delta`` within 1e-6 of the delta's largest |value|;
- the paged engine, greedy and sampled, two tenants and base in one
  batch: token-exact against the JAX engine with the same adapters, and
  against the port's own engines serving merged weights; the flat layout,
  ``speculation=3``, int8 + ``speculation=3`` and chunked prefill (paged
  and flat): token-exact against merged weights;
- the prefix cache never aliases a page across tenants; submit validation
  (the ``requests_shed_adapter`` counter, the rejected record, a storeless
  engine), the monitor's key-for-key adapter ledger, the hot unload, and a
  supervisor restart that keeps each continuation's adapter;
- ``lora_finetune`` fed JAX's ``init_adapter`` factors: the losses over 8
  steps within 1e-4 relative of JAX's, step 1's factor gradients within
  1e-5 of each gradient's largest |value|, the base untouched;
- slow tier: every engine variant token-exact against the JAX engine.

The JAX side runs its plain (non-Pallas) path, pinned per test.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.lora import AdapterStore as JStore
from apex_tpu.lora import init_adapter as jinit_adapter
from apex_tpu.lora import lora_finetune as jlora_finetune
from apex_tpu.lora import merge_adapter as jmerge_adapter
from apex_tpu.lora import random_adapter as jrandom_adapter
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.models.transformer import _lora_delta as jlora_delta
from apex_tpu.multi_tensor_apply import flatten_by_dtype as jflatten
from apex_tpu.ops import _support as jax_support
from apex_tpu.serving import EngineConfig as JEngineConfig
from apex_tpu.serving import InferenceEngine as JEngine
from apex_tpu.serving import Request as JRequest
from apex_tpu.serving import SamplingParams as JSampling
from apex_tpu_torch.convert import (adapter_from_jax, adapter_to_jax,
                                    load_jax_params, params_from_jax)
from apex_tpu_torch.lora import (LORA_TARGETS, AdapterStore,
                                 UnknownAdapterError, init_adapter,
                                 lora_finetune, merge_adapter,
                                 random_adapter, target_dims)
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.models.transformer import _lora_delta
from apex_tpu_torch.observability import (JsonlSink, MetricsRegistry,
                                          build_report, render_report)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.serving import (EngineConfig, EngineSupervisor,
                                    InferenceEngine, Request, SamplingParams)
from apex_tpu_torch.testing_faults import ServingFaultInjector

TINY = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
            vocab_size=64, max_position_embeddings=64)
RANK = 4


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


@pytest.fixture(scope="module")
def pair():
    """The tiny GPT in both packages with the same weights, the
    transformer's scaled x6 so the residual stream stops echoing the
    input token."""
    jm = JaxGPT(JaxConfig(**TINY, hidden_dropout=0.0, attention_dropout=0.0))
    params = jm.init(jax.random.PRNGKey(0))
    params = dict(params, transformer=jax.tree.map(
        lambda x: x * 6.0, params["transformer"]))
    tm = GPTModel(TransformerConfig(**TINY, hidden_dropout=0.0,
                                    attention_dropout=0.0), device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _jfactors(config, i, rank=RANK, scale=0.05):
    return jrandom_adapter(config, rank, jax.random.PRNGKey(i + 1),
                           scale=scale)


def _stores(jm, tm, ids, max_adapters=4):
    """The same adapters in a JAX store and a port store (the port's
    converted from JAX's draws); the port's factors returned too."""
    jstore = JStore(jm.config, RANK, max_adapters=max_adapters)
    store = AdapterStore(tm.config, RANK, max_adapters=max_adapters,
                         device="cpu")
    factors = {}
    for i, aid in enumerate(ids):
        jf = _jfactors(jm.config, i)
        jstore.load(aid, jf)
        factors[aid] = adapter_from_jax(jax.tree.map(np.asarray, jf))
        store.load(aid, factors[aid])
    return jstore, store, factors


def _merged_model(tm, factors):
    model = copy.deepcopy(tm)
    model.load_state_dict(merge_adapter(dict(tm.named_parameters()),
                                        factors))
    return model


def _prompts(lens, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, size=n).tolist() for n in lens]


def _req(cls, sp_cls, prompt, aid, n=6, **kw):
    return cls(prompt=list(prompt), max_new_tokens=n,
               sampling=sp_cls(adapter_id=aid, **kw))


def _banks_equal(store, jstore):
    for t in jstore.bank:
        for k in ("A", "B"):
            np.testing.assert_array_equal(store.bank[t][k].numpy(),
                                          np.asarray(jstore.bank[t][k]))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:     # the two packages' errors, compared
        return (type(exc).__name__, str(exc))


def test_store_lifecycle_and_errors_equal_jax(pair):
    jm, _, tm = pair
    assert LORA_TARGETS == ("query_key_value", "dense_h_to_4h")
    assert target_dims(tm.config) == {"query_key_value": (32, 96),
                                      "dense_h_to_4h": (32, 128)}
    jstore, store, _ = _stores(jm, tm, ("a", "b"), max_adapters=3)
    assert store.null_index == jstore.null_index == 3
    for t, (din, dout) in target_dims(tm.config).items():
        assert tuple(store.bank[t]["A"].shape) == (2, 4, din, RANK)
        assert tuple(store.bank[t]["B"].shape) == (2, 4, RANK, dout)
    _banks_equal(store, jstore)
    assert store.ids() == jstore.ids() == ["a", "b"]
    assert len(store) == 2 and "a" in store and "ghost" not in store

    def f(i, rank=RANK):
        jf = _jfactors(jm.config, i, rank)
        return jf, adapter_from_jax(jax.tree.map(np.asarray, jf))

    jf9, f9 = f(9)
    jf5, f5 = f(5)
    jf2, f2 = f(5, rank=2)
    wrong, jwrong = dict(f5), dict(jf5)
    wrong.pop("dense_h_to_4h")
    jwrong.pop("dense_h_to_4h")
    steps = [("index_of", ("a",), ("a",)), ("index_of", (None,), (None,)),
             ("index_of", ("ghost",), ("ghost",)),
             ("load", ("a", f9), ("a", jf9)),          # overwrite in place
             ("load", ("c", f5), ("c", jf5)),
             ("load", ("d", f5), ("d", jf5)),          # full
             ("load", ("a", f2), ("a", jf2)),          # rank mismatch
             ("load", ("a", wrong), ("a", jwrong)),    # missing target
             ("load", ("", f5), ("", jf5)),            # bad id
             ("unload", ("a",), ("a",)), ("unload", ("a",), ("a",)),
             ("index_of", ("a",), ("a",)),
             ("load", ("e", f5), ("e", jf5))]          # lowest index reused
    for name, args, jargs in steps:
        got = _outcome(lambda: getattr(store, name)(*args))
        want = _outcome(lambda: getattr(jstore, name)(*jargs))
        assert got == want, (name, args[:1])
        _banks_equal(store, jstore)
    assert store.ids() == jstore.ids() == ["b", "c", "e"]
    for t in store.bank:          # the null row stays zero throughout
        assert not store.bank[t]["A"][:, store.null_index].any()
    for kw in (dict(rank=0), dict(rank=4, max_adapters=0)):
        got = _outcome(lambda: AdapterStore(tm.config, device="cpu", **kw))
        assert got == _outcome(lambda: JStore(jm.config, **kw))
    assert issubclass(UnknownAdapterError, KeyError)


def test_load_writes_bank_in_place(pair):
    """The engine holds the bank's tensors: load and unload must write
    their storage, never rebind them."""
    _, _, tm = pair
    store = AdapterStore(tm.config, RANK, max_adapters=2, device="cpu")
    ptrs = {(t, k): v.data_ptr() for t, f in store.bank.items()
            for k, v in f.items()}
    store.load("a", random_adapter(tm.config, RANK,
                                   torch.Generator().manual_seed(1),
                                   device="cpu"))
    store.unload("a")
    assert ptrs == {(t, k): v.data_ptr() for t, f in store.bank.items()
                    for k, v in f.items()}
    fresh = init_adapter(tm.config, RANK, torch.Generator().manual_seed(2),
                         device="cpu")
    assert all(not f["B"].any() and f["A"].any() for f in fresh.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_adapter_matches_jax(pair, dtype):
    jm, params, tm = pair
    jparams = jax.tree.map(lambda x: x.astype(getattr(jnp, dtype)), params)
    jf = _jfactors(jm.config, 2)
    want = params_from_jax(jax.tree.map(np.asarray,
                                        jmerge_adapter(jparams, jf)))
    base = params_from_jax(jax.tree.map(np.asarray, jparams))
    snapshot = {k: v.clone() for k, v in base.items()}
    got = merge_adapter(base, adapter_from_jax(jax.tree.map(np.asarray, jf)))
    assert all(torch.equal(base[k], snapshot[k]) for k in base)
    changed = [k for k in got if not torch.equal(got[k], base[k])]
    assert sorted(changed) == sorted(
        f"transformer.layers.{i}.{p}.weight" for i in range(2)
        for p in ("self_attention.query_key_value", "mlp.dense_h_to_4h"))
    for key in got:
        if dtype == "bfloat16":
            assert torch.equal(got[key], want[key]), key
        else:
            ulp = torch.finfo(torch.float32).eps * want[key].abs().clamp_min(
                torch.finfo(torch.float32).tiny)
            assert bool(((got[key] - want[key]).abs() <= ulp).all()), key


def test_lora_delta_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(5, 3, 32).astype(np.float32)
    a = (0.05 * rng.randn(3, 32, RANK)).astype(np.float32)
    b = (0.05 * rng.randn(3, RANK, 96)).astype(np.float32)
    want = np.asarray(jlora_delta(jnp.asarray(x), {"A": jnp.asarray(a),
                                                   "B": jnp.asarray(b)}))
    got = _lora_delta(torch.from_numpy(x), {"A": torch.from_numpy(a),
                                            "B": torch.from_numpy(b)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 3, 96)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_adapter_conversion_round_trip(pair):
    jm, _, _ = pair
    jf = jax.tree.map(np.asarray, _jfactors(jm.config, 0))
    back = adapter_to_jax(adapter_from_jax(jf))
    for t in jf:
        for k in ("A", "B"):
            np.testing.assert_array_equal(back[t][k], jf[t][k])


def _mixed(cls, sp_cls):
    prompts = _prompts([5, 9, 3])
    return [_req(cls, sp_cls, prompts[0], "ta"),
            _req(cls, sp_cls, prompts[0], "tb"),
            _req(cls, sp_cls, prompts[1], None),
            _req(cls, sp_cls, prompts[2], "ta", temperature=0.8, top_k=8,
                 seed=11),
            _req(cls, sp_cls, prompts[1], "tb", temperature=1.0, seed=4)]


def _merged_tokens(tm, factors, reqs, ecfg):
    """Each request served alone by an engine on its tenant's merged
    weights (base requests on the base model), with the same sampling."""
    out = {}
    for aid in {r.sampling.adapter_id for r in reqs}:
        model = tm if aid is None else _merged_model(tm, factors[aid])
        sel = [r for r in reqs if r.sampling.adapter_id == aid]
        res = InferenceEngine(model, ecfg, device="cpu").serve([
            Request(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens,
                    sampling=SamplingParams(
                        temperature=r.sampling.temperature,
                        top_k=r.sampling.top_k, seed=r.sampling.seed))
            for r in sel])
        out.update({r.request_id: x.tokens for r, x in zip(sel, res)})
    return [out[r.request_id] for r in reqs]


def test_paged_engine_token_exact_against_jax_engine_and_merged(pair):
    jm, params, tm = pair
    jstore, store, factors = _stores(jm, tm, ("ta", "tb"))
    cfg = dict(max_slots=4, max_len=64)
    jres = JEngine(jm, params, JEngineConfig(**cfg),
                   adapters=jstore).serve(_mixed(JRequest, JSampling))
    reqs = _mixed(Request, SamplingParams)
    eng = InferenceEngine(tm, EngineConfig(**cfg), adapters=store,
                          device="cpu")
    res = eng.serve(reqs)
    got = [r.tokens for r in res]
    assert got == [r.tokens for r in jres]
    assert [r.adapter_id for r in res] == ["ta", "tb", None, "ta", "tb"]
    assert got == _merged_tokens(tm, factors, reqs, EngineConfig(**cfg))
    # the tenants really differ from the base model on the same prompt
    assert len({tuple(got[0]), tuple(got[1])}) == 2
    assert eng.metrics.counters()["adapter0_requests"] == 2


VARIANTS = {"flat": dict(kv_layout="flat"),
            "spec": dict(speculation=3),
            "int8_spec": dict(speculation=3, kv_dtype="int8"),
            "chunked_paged": dict(page_size=4, prefill_token_budget=4),
            "chunked_flat": dict(kv_layout="flat", prefill_token_budget=4)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_engines_token_exact_against_merged(pair, variant):
    jm, _, tm = pair
    _, store, factors = _stores(jm, tm, ("ta", "tb"))
    ecfg = EngineConfig(max_slots=4, max_len=64, **VARIANTS[variant])
    reqs = _mixed(Request, SamplingParams)
    res = InferenceEngine(tm, ecfg, adapters=store, device="cpu").serve(reqs)
    assert [r.tokens for r in res] == _merged_tokens(tm, factors, reqs, ecfg)


def test_prefix_cache_no_page_aliased_across_tenants(pair):
    jm, _, tm = pair
    _, store, factors = _stores(jm, tm, ("a", "b"))
    prompt = _prompts([8], seed=17)[0]
    ecfg = EngineConfig(max_slots=4, max_len=32, page_size=4,
                        prefix_cache=True)
    eng = InferenceEngine(tm, ecfg, adapters=store, device="cpu")
    first = eng.serve([_req(Request, SamplingParams, prompt, aid)
                       for aid in ("a", "b", None)])
    assert eng.metrics.counters()["prefix_hits"] == 0
    again = eng.serve([_req(Request, SamplingParams, prompt, aid)
                       for aid in ("a", None)])   # same tenants: hits
    assert eng.metrics.counters()["prefix_hits"] == 2
    # each tenant's chain is its own: three distinct interned chains
    chains = {eng._plan_prefix(_req(Request, SamplingParams, prompt,
                                    aid))[0] for aid in ("a", "b", None)}
    assert len(chains) == 3
    want = _merged_tokens(tm, factors, [
        _req(Request, SamplingParams, prompt, aid) for aid in ("a", "b",
                                                              None)], ecfg)
    assert [r.tokens for r in first] == want
    assert [r.tokens for r in again] == [want[0], want[2]]


def test_submit_validation_sheds_unknown_adapters(pair):
    jm, _, tm = pair
    _, store, _ = _stores(jm, tm, ("a",))
    ecfg = EngineConfig(max_slots=2, max_len=16)
    eng = InferenceEngine(tm, ecfg, adapters=store, device="cpu")
    req = _req(Request, SamplingParams, [1, 2], "ghost", n=2)
    with pytest.raises(UnknownAdapterError, match="ghost"):
        eng.submit(req)
    assert eng.metrics.counters()["requests_shed_adapter"] == 1
    res = eng.completed[req.request_id]
    assert res.finish_reason == "rejected" and res.adapter_id == "ghost"
    assert eng.queued_count == 0 and eng.active_count == 0
    bare = InferenceEngine(tm, ecfg, device="cpu")
    with pytest.raises(UnknownAdapterError, match="AdapterStore"):
        bare.submit(_req(Request, SamplingParams, [1], "a", n=1))
    assert bare.metrics.counters()["requests_shed_adapter"] == 1
    with pytest.raises(ValueError, match="adapter bank lives on"):
        InferenceEngine(tm, ecfg, adapters=type(
            "Elsewhere", (), {"device": torch.device("meta")})(),
            device="cpu")


def test_ledger_reconciles_key_for_key(pair, tmp_path):
    jm, _, tm = pair
    _, store, _ = _stores(jm, tm, ("a", "b", "c"))
    log = tmp_path / "lora.jsonl"
    eng = InferenceEngine(tm, EngineConfig(max_slots=2, max_len=16),
                          metrics=MetricsRegistry([JsonlSink(str(log))]),
                          adapters=store, device="cpu")
    reqs = [_req(Request, SamplingParams, [1, 2], aid, n=2)
            for aid in ["a", "a", "a", "b", "b", None, "c"]]
    for r in reqs:
        eng.submit(r)
    with pytest.raises(UnknownAdapterError):
        eng.submit(_req(Request, SamplingParams, [1], "ghost", n=1))
    for r in reqs:
        assert eng.cancel(r.request_id)
    eng.close()
    report = build_report(str(log))
    sec = report["adapters"]
    ix = {a: str(store.index_of(a)) for a in "abc"}
    assert sec["admitted_by_adapter"] == {"a": 3, "b": 2, "c": 1}
    assert sec["admitted_by_index"] == {ix["a"]: 3, ix["b"]: 2, ix["c"]: 1}
    assert sec["counters"] == {f"adapter{ix['a']}_requests": 3,
                               f"adapter{ix['b']}_requests": 2,
                               f"adapter{ix['c']}_requests": 1}
    assert sec["shed_unknown"] == 1
    assert sec["finished_by_adapter"] == {"a": 3, "b": 2, "c": 1,
                                          "ghost": 1}
    assert "adapters (multi-LoRA):" in render_report(report)


def test_hot_unload_degrades_inflight_rejects_new(pair):
    _, _, tm = pair
    # a strong adapter, so its removal shows in the stream
    factors = {"a": random_adapter(tm.config, RANK,
                                   torch.Generator().manual_seed(5), 0.5,
                                   device="cpu")}
    store = AdapterStore(tm.config, RANK, device="cpu")
    store.load("a", factors["a"])
    ecfg = EngineConfig(max_slots=2, max_len=32)
    prompt = _prompts([6], seed=9)[0]
    eng = InferenceEngine(tm, ecfg, adapters=store, device="cpu")
    # queued under "a", unloaded before its prefill: base output
    queued = _req(Request, SamplingParams, prompt, "a")
    eng.submit(queued)
    store.unload("a")
    while queued.request_id not in eng.completed:
        eng.tick()
    with pytest.raises(UnknownAdapterError):
        eng.submit(_req(Request, SamplingParams, prompt, "a"))
    base = InferenceEngine(tm, ecfg, device="cpu").serve(
        [_req(Request, SamplingParams, prompt, None)])[0].tokens
    assert eng.completed[queued.request_id].tokens == base
    # decoding under "a" when it is unloaded: adapter tokens until the
    # unload, the zero row from the next step on
    store.load("a", factors["a"])
    live = _req(Request, SamplingParams, prompt, "a")
    eng.submit(live)
    eng.tick()
    eng.tick()
    before = len(eng._active[0].tokens)
    store.unload("a")
    while live.request_id not in eng.completed:
        eng.tick()
    tokens = eng.completed[live.request_id].tokens
    tuned = _merged_tokens(tm, factors, [live], ecfg)[0]
    assert len(tokens) == 6 and tokens[:before] == tuned[:before]
    assert tokens != tuned and tokens != base


def test_supervisor_restart_keeps_each_adapter(pair):
    jm, _, tm = pair
    _, store, _ = _stores(jm, tm, ("a", "b"))
    ecfg = EngineConfig(max_slots=3, max_len=32)

    def reqs():
        return [_req(Request, SamplingParams, p, aid) for p, aid in
                zip(_prompts([5, 7, 4], seed=2), ("a", None, "b"))]

    clean = InferenceEngine(tm, ecfg, adapters=store, device="cpu").serve(
        reqs())
    sup = EngineSupervisor(tm, ecfg, adapters=store, device="cpu",
                           faults=ServingFaultInjector(
                               decode_raise_calls={3}))
    res = sup.serve(reqs())
    assert sup.metrics.counters()["engine_restarts"] == 1
    assert [r.tokens for r in res] == [r.tokens for r in clean]
    assert [r.adapter_id for r in res] == ["a", None, "b"]


def test_per_slot_lora_needs_the_cache_list(pair):
    _, _, tm = pair
    hidden = torch.zeros(3, 1, 32)
    with pytest.raises(NotImplementedError, match="LIST"):
        tm.transformer(hidden, lora={})


class _Recording(FusedAdam):
    """FusedAdam that keeps each step's gradient of its one buffer."""

    def __init__(self, params, lr):
        super().__init__(params, lr=lr)
        self.grads = []

    def step(self, *args, **kwargs):
        self.grads.append(self.param_groups[0]["params"][0].grad.clone())
        return super().step(*args, **kwargs)


def test_finetune_matches_jax_and_keeps_the_base(pair):
    jm, params, tm = pair
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, 64, size=(2, 2, 8)).astype(np.int32)
    labels = rng.randint(0, 64, size=(2, 2, 8)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jf = jax.vmap(lambda k: jinit_adapter(jm.config, 2, k))(keys)
    jfac, jlosses = jlora_finetune(jm, params, jnp.asarray(tokens),
                                   jnp.asarray(labels), rank=2, steps=8,
                                   lr=1e-2, factors=jf)

    def cohort(f):
        losses = jax.vmap(lambda fj, t, la: jm.apply(
            jmerge_adapter(params, fj), t, la))(f, jnp.asarray(tokens),
                                               jnp.asarray(labels))
        return jnp.mean(losses)

    jgrads, _, _ = jflatten(jax.grad(cohort)(jf))
    snapshot = {k: v.clone() for k, v in tm.state_dict().items()}
    opts = []

    def make(ps):
        opts.append(_Recording(ps, lr=1e-2))
        return opts[-1]

    factors, losses = lora_finetune(
        tm, torch.from_numpy(tokens).long(), torch.from_numpy(labels).long(),
        rank=2, steps=8, lr=1e-2, optimizer=make,
        factors=adapter_from_jax(jax.tree.map(np.asarray, jf)))
    want = np.asarray(jlosses)
    assert tuple(losses.shape) == want.shape == (8, 2)
    assert np.abs(losses.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    assert (losses[-1] < losses[0]).all()
    g1, jg1 = opts[0].grads[0].numpy(), np.asarray(jgrads["float32"])
    assert g1.shape == jg1.shape
    assert np.abs(g1 - jg1).max() <= 1e-5 * np.abs(jg1).max()
    assert all(torch.equal(snapshot[k], v)
               for k, v in tm.state_dict().items())
    got = adapter_to_jax(factors)
    for t in got:
        for k in ("A", "B"):
            np.testing.assert_allclose(got[t][k], np.asarray(jfac[t][k]),
                                       rtol=0, atol=2e-4)
    with pytest.raises(ValueError, match="labels"):
        lora_finetune(tm, torch.zeros(1, 2, 8, dtype=torch.long),
                      torch.zeros(1, 2, 7, dtype=torch.long))


@pytest.mark.slow
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_engines_token_exact_against_jax_engine(pair, variant):
    jm, params, tm = pair
    jstore, store, _ = _stores(jm, tm, ("ta", "tb"))
    cfg = dict(max_slots=4, max_len=64, **VARIANTS[variant])
    jres = JEngine(jm, params, JEngineConfig(**cfg),
                   adapters=jstore).serve(_mixed(JRequest, JSampling))
    res = InferenceEngine(tm, EngineConfig(**cfg), adapters=store,
                          device="cpu").serve(_mixed(Request, SamplingParams))
    assert [r.tokens for r in res] == [r.tokens for r in jres]
