"""The port's amp against the JAX package's, on the CPU (the counterpart of
``tests/test_amp.py``).

- Opt levels, their properties and overrides, ``half_dtype`` (bf16 and
  fp16), ``Policy.wrap`` and ``from_names``, the half / float / promote
  wrappers and their ``register_*`` forms, ``disable_casts`` (a
  ``contextvars`` flag, restored on exit), ``master_params`` from the
  optimizer's state.
- Static, dynamic and hysteresis loss-scaler walks over one seeded
  overflow pattern, state for state equal to JAX's; ``unscale`` zeroing
  non-finite values (bitwise JAX's in f32 and bf16); ``state_dict``
  round trips; ``apply_if_finite``; fp16 overflow, backoff and regrowth.
- The whole amp flow (``initialize("O2", half_dtype=float32)``: master
  weights and a dynamic scale over f32) on a tiny GPT for five steps with
  an overflow injected after the backward of step 2, against the JAX
  package's ``GPTModel`` from the same weights (``load_jax_params``): the
  losses (rtol 1e-5), the scaler state at every step (equal), and the
  parameters after five steps (atol 1e-4, as
  ``test_torch_gpt_training.py`` holds Adam steps). The bf16 O2 run is
  the slow test, to a stated tolerance; the fp16 O2 run (fp16 params and
  compute over fp32 masters) a fast one: equal scaler walks, losses to
  rtol 1e-4.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.ops import _support as jax_support
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import amp
from apex_tpu_torch.convert import load_jax_params, params_to_jax
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.optimizers import FusedAdam

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _scaler_state(st):
    return (float(st.loss_scale), int(st.growth_tracker),
            int(st.hysteresis_tracker), int(st.unskipped))


def test_opt_levels_and_overrides():
    for lvl in ("O0", "O1", "O2", "O3"):
        st, jst = amp.initialize(lvl, **CPU), jamp.initialize(lvl)
        assert st.properties.opt_level == lvl
        for f in ("enabled", "cast_ops", "keep_batchnorm_fp32",
                  "master_weights", "loss_scale"):
            assert getattr(st.properties, f) == getattr(jst.properties, f)
        assert float(st.loss_scale) == float(jst.loss_scale)
    with pytest.raises(ValueError):
        amp.initialize("O4", **CPU)
    o2 = amp.initialize("O2", **CPU)
    assert o2.properties.master_weights
    assert o2.policy.param_dtype == torch.bfloat16
    assert o2.properties.cast_model_type == torch.bfloat16
    o2 = amp.initialize("O2", master_weights=False, loss_scale=128.0,
                        keep_batchnorm_fp32=False, **CPU)
    assert not o2.properties.master_weights
    assert float(o2.loss_scale) == 128.0 and not o2.scaler.dynamic
    assert amp.initialize("O1", cast_model_type=torch.float16,
                          **CPU).properties.cast_model_type == torch.float16
    fp16 = amp.initialize("O2", half_dtype=torch.float16, **CPU)
    assert fp16.policy.param_dtype == fp16.policy.compute_dtype == \
        torch.float16
    assert fp16.properties.cast_model_type == torch.float16
    assert amp.initialize("O1", **CPU).policy == amp.Policy(
        torch.float32, torch.bfloat16, torch.float32)
    assert set(amp.OPT_LEVELS) == set(jamp.OPT_LEVELS)


def test_initialize_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        amp.initialize("O2")


def test_policy_wrap_and_from_names():
    policy = amp.Policy(torch.float32, torch.bfloat16, torch.float32)
    seen = {}

    def probe(x, y=None):
        seen["dtype"] = (x.dtype, y.dtype)
        return x * 2

    out = policy.wrap(probe)(torch.ones(4), y=torch.ones(2))
    assert out.dtype == torch.float32
    assert seen["dtype"] == (torch.bfloat16, torch.bfloat16)
    for names in ("params=float32,compute=bfloat16,output=float32",
                  "p=f32,c=bf16,o=f32", "p=f16,c=f16,o=f32"):
        got, want = amp.Policy.from_names(names), \
            jamp.Policy.from_names(names)
        for f in ("param_dtype", "compute_dtype", "output_dtype"):
            assert str(getattr(got, f)).replace("torch.", "") == \
                jnp.dtype(getattr(want, f)).name
    model = torch.nn.Linear(3, 2)
    assert policy.cast_to_compute(model) is model
    assert model.weight.dtype == torch.bfloat16
    assert isinstance(model.weight, torch.nn.Parameter)
    tree = policy.cast_to_param({"a": torch.ones(2, dtype=torch.bfloat16),
                                 "n": torch.arange(3), "s": 1.5})
    assert tree["a"].dtype == torch.float32
    assert tree["n"].dtype == torch.int64 and tree["s"] == 1.5


def test_half_float_promote_and_register():
    assert amp.half_function(lambda x: x)(torch.ones(3)).dtype == \
        torch.bfloat16
    assert amp.half_function(lambda x: x, torch.float16)(
        torch.ones(3)).dtype == torch.float16
    assert amp.float_function(lambda x: x)(
        torch.ones(3, dtype=torch.bfloat16)).dtype == torch.float32
    out = amp.promote_function(lambda x, y: x + y)(
        torch.ones(3, dtype=torch.bfloat16), torch.ones(3))
    assert out.dtype == torch.float32
    assert amp.promote_function(lambda n: n)(torch.arange(2)).dtype == \
        torch.int64
    mod = types.SimpleNamespace(h=lambda x: x.dtype, f=lambda x: x.dtype,
                                p=lambda x, y: (x.dtype, y.dtype))
    amp.register_half_function(mod, "h")
    amp.register_float_function(mod, "f")
    amp.register_promote_function(mod, "p")
    assert mod.h(torch.ones(2)) == torch.bfloat16
    assert mod.f(torch.ones(2, dtype=torch.bfloat16)) == torch.float32
    assert mod.p(torch.ones(2, dtype=torch.bfloat16), torch.ones(2)) == \
        (torch.float32, torch.float32)


def test_disable_casts_suspends_every_wrapper():
    fn = amp.half_function(lambda x: x.dtype)
    pol = amp.Policy(torch.float32, torch.bfloat16, torch.float32)
    wrapped = pol.wrap(lambda x: x.dtype)
    x32 = torch.ones(2)
    assert fn(x32) == torch.bfloat16 and wrapped(x32) == torch.bfloat16
    with amp.disable_casts():
        assert fn(x32) == torch.float32 and wrapped(x32) == torch.float32
    assert fn(x32) == torch.bfloat16
    with pytest.raises(KeyError):
        with amp.disable_casts():
            raise KeyError("inside")
    assert fn(x32) == torch.bfloat16          # restored after a raise


def test_master_params_from_the_optimizer_state():
    p = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    opt = FusedAdam([p], lr=1e-3, master_weights=True)
    p.grad = torch.ones(3, dtype=torch.bfloat16)
    opt.step()
    masters = amp.master_params(opt)
    assert len(masters) == 1 and masters[0].dtype == torch.float32
    assert amp.master_params(FusedAdam([p], lr=1e-3)) == []


def _overflow_pattern(n=40, seed=0):
    return list(np.random.RandomState(seed).rand(n) < 0.3)


@pytest.mark.parametrize("kw", [
    dict(loss_scale=128.0),
    dict(loss_scale="dynamic", init_scale=2.0 ** 8, scale_window=3),
    dict(loss_scale="dynamic", init_scale=2.0 ** 4, scale_window=2,
         hysteresis=2, min_loss_scale=2.0, max_loss_scale=2.0 ** 6),
    dict(loss_scale="dynamic", init_scale=2.0 ** 8, scale_factor=3.0,
         scale_window=4, hysteresis=3),
], ids=["static", "dynamic", "hysteresis_bounds", "factor3_hysteresis3"])
def test_scaler_walk_matches_jax_state_for_state(kw):
    kw = dict(kw)
    mode = kw.pop("loss_scale")
    sc, jsc = amp.LossScaler(mode, **kw), jamp.LossScaler(mode, **kw)
    st, jst = sc.init(**CPU), jsc.init()
    assert _scaler_state(st) == _scaler_state(jst)
    for overflow in _overflow_pattern():
        st = sc.update(st, torch.tensor(overflow))
        jst = jsc.update(jst, jnp.asarray(overflow))
        assert _scaler_state(st) == _scaler_state(jst)
        assert st.loss_scale.dtype == torch.float32
        assert st.growth_tracker.dtype == torch.int32


def test_scaler_hysteresis_absorbs_then_backs_off():
    sc = amp.LossScaler("dynamic", init_scale=2.0 ** 8, hysteresis=2)
    st = sc.update(sc.init(**CPU), torch.tensor(True))
    assert float(st.loss_scale) == 2.0 ** 8
    st = sc.update(st, torch.tensor(True))
    assert float(st.loss_scale) == 2.0 ** 7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unscale_zeroes_non_finite_like_jax(dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.RandomState(3)
    tree = {"a": rng.randn(5).astype(np.float32) * 300,
            "b": rng.randn(2, 3).astype(np.float32)}
    tree["a"][1], tree["b"][0, 2] = np.nan, -np.inf
    sc, jsc = amp.LossScaler(256.0), jamp.LossScaler(256.0)
    grads = {k: torch.tensor(v).to(tdt) for k, v in tree.items()}
    out, found = sc.unscale(grads, sc.init(**CPU))
    jout, jfound = jsc.unscale({k: jnp.asarray(v, jdt)
                                for k, v in tree.items()}, jsc.init())
    assert out is grads and bool(found) and bool(jfound)
    for k in tree:
        assert torch.isfinite(out[k]).all()
        np.testing.assert_array_equal(out[k].float().numpy(),
                                      np.asarray(jout[k], np.float32))
    assert bool(amp.all_finite(out))
    assert not bool(amp.all_finite({"x": torch.tensor([1.0, np.inf])}))


def test_state_dict_round_trip():
    st = amp.initialize("O2", num_losses=2, **CPU)
    d = amp.state_dict(st)
    assert set(d) == {"loss_scaler0", "loss_scaler1"}
    assert d == jamp.state_dict(jamp.initialize("O2", num_losses=2))
    st2 = amp.load_state_dict(st, {"loss_scaler1": {
        "loss_scale": 42.0, "growth_tracker": 3, "unskipped": 9}})
    assert _scaler_state(st2.scaler_states[1]) == (42.0, 3, 1, 9)
    assert _scaler_state(st2.scaler_states[0]) == \
        _scaler_state(st.scaler_states[0])
    assert st2.scaler_states[1].loss_scale.device.type == "cpu"


def test_apply_if_finite_selects_on_the_device():
    params = {"w": torch.ones(3), "b": torch.zeros(2)}

    def step(p):
        return {k: v + 1 for k, v in p.items()}

    kept = amp.apply_if_finite(torch.tensor(False), step, params)
    skipped = amp.apply_if_finite(torch.tensor(True), step, params)
    assert torch.equal(kept["w"], torch.full((3,), 2.0))
    assert torch.equal(skipped["w"], params["w"])
    a, b = amp.apply_if_finite(torch.tensor(True),
                               lambda x, y: (x * 2, y * 3),
                               torch.ones(2), torch.ones(2))
    assert torch.equal(a, torch.ones(2)) and torch.equal(b, torch.ones(2))


def test_unscale_and_update_and_scale_loss():
    sc = amp.LossScaler("dynamic", init_scale=2.0 ** 4)
    st = sc.init(**CPU)
    loss = amp.scale_loss(torch.tensor(1.5, dtype=torch.bfloat16), st)
    assert loss.dtype == torch.float32 and float(loss) == 24.0
    grads, found, st2 = amp.unscale_and_update(
        [torch.full((2,), 32.0)], sc, st)
    assert not bool(found) and torch.equal(grads[0], torch.full((2,), 2.0))
    assert int(st2.growth_tracker) == 1


def test_fp16_overflow_backoff_and_recovery():
    sc = amp.LossScaler("dynamic", init_scale=2.0 ** 16, scale_window=2)
    st = sc.init(**CPU)
    big = (torch.full((4,), 4.0) * st.loss_scale).to(torch.float16)
    assert torch.isinf(big).all()
    _, found = sc.unscale([big], st)
    st = sc.update(st, found)
    assert bool(found) and float(st.loss_scale) == 2.0 ** 15
    for _ in range(2):
        g = (torch.ones(4) * st.loss_scale / 2.0 ** 14).to(torch.float16)
        _, found = sc.unscale([g], st)
        assert not bool(found)
        assert g.dtype == torch.float16
        st = sc.update(st, found)
    assert float(st.loss_scale) == 2.0 ** 16


TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0)
OVERFLOW_STEP = 2


def _amp_flow(half, steps=5, lr=1e-3):
    """The JAX and the port amp O2 flows on one tiny GPT: ``(jax losses,
    jax scaler states, jax params, port losses, port scaler states,
    port model)``; the port's grads take an inf after the backward of
    ``OVERFLOW_STEP`` (JAX's take it after ``jax.grad``)."""
    jhalf = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
             torch.float16: jnp.float16}[half]
    jst = jamp.initialize("O2", half_dtype=jhalf)
    jm = JaxGPT(JaxConfig(**TINY, compute_dtype=jhalf))
    params = jm.init(jax.random.PRNGKey(5))
    tm = GPTModel(TransformerConfig(**TINY, compute_dtype=half), **CPU)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    params = jst.policy.cast_to_param(params)
    tst = amp.initialize("O2", half_dtype=half, **CPU)
    tst.policy.cast_to_param(tm)
    rng = np.random.RandomState(6)
    tokens = rng.randint(0, TINY["vocab_size"], (2, 24)).astype(np.int32)
    labels = rng.randint(0, TINY["vocab_size"], (2, 24)).astype(np.int32)
    jsc, jss = jst.scaler, jst.scaler_states[0]
    jopt = JaxFusedAdam(lr=lr, master_weights=True)
    jos = jopt.init(params)

    @jax.jit
    def grads_of(p, ss):
        return jax.value_and_grad(lambda q: jsc.scale(jm.apply(
            q, jnp.asarray(tokens), jnp.asarray(labels)), ss))(p)

    jlosses, jstates = [], []
    for i in range(steps):
        sloss, g = grads_of(params, jss)
        jlosses.append(float(sloss) / float(jss.loss_scale))
        if i == OVERFLOW_STEP:
            emb = g["embedding"]["word_embeddings"]
            emb["weight"] = emb["weight"].at[0, 0].set(jnp.inf)
        g, found = jsc.unscale(g, jss)
        params, jos = jopt.step(g, params, jos, found_inf=found)
        jss = jsc.update(jss, found)
        jstates.append(_scaler_state(jss))

    sc, ss = tst.scaler, tst.scaler_states[0]
    opt = FusedAdam(tm.parameters(), lr=lr, master_weights=True)
    batch = (torch.from_numpy(tokens).long(), torch.from_numpy(labels).long())
    tlosses, tstates = [], []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = tm(*batch)
        amp.scale_loss(loss, ss).backward()
        tlosses.append(float(loss.detach()))
        if i == OVERFLOW_STEP:
            tm.embedding.word_embeddings.weight.grad[0, 0] = float("inf")
        _, found = sc.unscale([p.grad for p in tm.parameters()], ss)
        opt.step(found_inf=found)
        ss = sc.update(ss, found)
        tstates.append(_scaler_state(ss))
    return jlosses, jstates, params, tlosses, tstates, tm


def test_amp_o2_flow_on_a_tiny_gpt_matches_jax():
    jl, js, jp, tl, ts, tm = _amp_flow(torch.float32)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert ts == js
    assert ts[OVERFLOW_STEP][0] == 2.0 ** 15 and ts[OVERFLOW_STEP][1] == 0
    assert tl[-1] < tl[0]
    assert tl[OVERFLOW_STEP + 1] == pytest.approx(tl[OVERFLOW_STEP],
                                                  rel=1e-6)
    got = params_to_jax(tm.state_dict())
    for key, want in jax.tree_util.tree_flatten_with_path(jp)[0]:
        leaf = got
        for k in key:
            leaf = leaf[k.key]
        np.testing.assert_allclose(np.asarray(leaf, np.float32),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=1e-4, err_msg=str(key))


def test_amp_o2_fp16_flow_on_a_tiny_gpt_matches_jax():
    """fp16 params and compute over fp32 masters, the dtype dynamic loss
    scaling exists for (JAX's ``TestFp16Path``): the scaler walks agree
    state for state (the injected overflow halves 2^16), the losses to rtol
    1e-4 (fp16 keeps 11 bits, so the two frameworks' rounding points move
    a loss by ~1e-5 of itself), every parameter stays fp16 and the loss
    falls."""
    jl, js, _, tl, ts, tm = _amp_flow(torch.float16)
    assert all(p.dtype == torch.float16 for p in tm.parameters())
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert ts == js
    assert ts[OVERFLOW_STEP][0] == 2.0 ** 15 and ts[OVERFLOW_STEP][1] == 0
    assert tl[-1] < tl[0]


@pytest.mark.slow
def test_amp_o2_bf16_flow_matches_jax_to_tolerance():
    """bf16 params and compute over fp32 masters: the frameworks round bf16
    at other points (see test_torch_gpt_training.py), so the losses agree
    to rtol 2e-2; the scaler walks agree exactly."""
    jl, js, _, tl, ts, tm = _amp_flow(torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert ts == js
    assert tl[-1] < tl[0]
