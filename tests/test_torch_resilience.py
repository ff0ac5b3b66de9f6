"""The port's resilient training loop against the JAX package, on the CPU.

- ``Watchdog``: sequences drawn by hypothesis (NaN and inf among them)
  give the JAX watchdog's verdicts: reason, step, ``first_bad_step`` and
  detail string.
- ``run_training`` in both packages on a tiny f32 GPT (2 layers, hidden
  64, 4 heads, vocab 128, b 2 x s 16; the JAX weights carried over with
  ``load_jax_params``), ``FusedAdam`` and a dynamic ``LossScaler``, under
  the same ``FaultInjector`` schedules: (a) a NaN window, rollback and
  recovery; (b) an injected preemption and a resume from a fresh state;
  (c) save failures within the retry budget and a bit-flipped newest step
  before the resume; (d) dropout 0.1 from a base key, where the replay
  after the rollback must draw the same masks. Both sides give the same
  status, steps and rollbacks, the same telemetry key for key (the
  ``ckpt_*`` keys too; ``retraces`` stays 0 in the port, which compiles
  nothing), the same history steps and skipped flags, losses within 1e-5
  relative and final parameters within atol 1e-4 (the f32 bar of
  ``tests/test_torch_gpt_training.py`` after Adam steps). The JAX step is
  jitted once per configuration and reused across scenarios.
- Port-only: a resume is bitwise an uninterrupted run; a real SIGTERM
  from ``batch_fn`` makes an emergency save that resumes; an exhausted
  budget and a verdict without a manager raise ``TrainingDiverged``; the
  scaler's trackers round-trip and a rollback halves the scale (floor
  1); ``python -m apex_tpu_torch.monitor`` over a JSONL sink reconciles
  with the telemetry and shows the checkpoints section.
"""

import math
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from apex_tpu import resilience as jres
from apex_tpu import testing_faults as jfaults
from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import TransformerConfig as JaxConfig
from apex_tpu.ops import _support as jax_support
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import resilience as tres
from apex_tpu_torch import testing_faults as tfaults
from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.checkpoint import ShardedCheckpointManager
from apex_tpu_torch.convert import load_jax_params, params_to_jax
from apex_tpu_torch.models import GPTModel, TransformerConfig
from apex_tpu_torch.observability import (JsonlSink, MetricsRegistry,
                                          build_report, render_report)
from apex_tpu_torch.observability.report import CHECKPOINT_INCIDENT_COUNTERS
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils import prng

TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=128, max_position_embeddings=16)
B, S, LR, STEPS = 2, 16, 1e-3, 12


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    """Pin apex_tpu to its plain jnp path: other test modules export
    ``APEX_TPU_FORCE_PALLAS=interpret`` process-wide at import."""
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


def _batch_np(step):
    rs = np.random.RandomState(100 + step)
    tokens = rs.randint(0, TINY["vocab_size"], (B, S)).astype(np.int32)
    labels = rs.randint(0, TINY["vocab_size"], (B, S)).astype(np.int32)
    return tokens, labels, np.ones((B, S), np.float32)


def _jax_batch(step):
    t, l, m = _batch_np(step)
    return {"tokens": jnp.asarray(t), "labels": jnp.asarray(l),
            "loss_mask": jnp.asarray(m)}


def _torch_batch(step):
    t, l, m = _batch_np(step)
    return {"tokens": torch.from_numpy(t).long(),
            "labels": torch.from_numpy(l).long(),
            "loss_mask": torch.from_numpy(m)}


_JAX = {}


def _jax_side(dropout):
    """``(model, init params, jitted step, scaler)`` of one configuration,
    built once: every scenario reuses the compiled step."""
    if dropout not in _JAX:
        jm = JaxGPT(JaxConfig(**TINY, hidden_dropout=dropout,
                              attention_dropout=dropout))
        params = jm.init(jax.random.PRNGKey(3))
        scaler = JaxLossScaler("dynamic")

        def loss_fn(p, batch, rng):
            return jm.apply(p, batch["tokens"], batch["labels"],
                            loss_mask=batch["loss_mask"], rng=rng,
                            deterministic=rng is None)

        step = jres.make_resilient_train_step(loss_fn, JaxFusedAdam(lr=LR),
                                              scaler)
        _JAX[dropout] = (jm, params, step, scaler)
    return _JAX[dropout]


def _jax_state(dropout):
    _, params, _, scaler = _jax_side(dropout)
    fresh = jax.tree.map(jnp.array, params)     # the step donates its state
    return jres.make_train_state(fresh, JaxFusedAdam(lr=LR).init(fresh),
                                 scaler.init())


def _torch_run_parts(dropout):
    """A fresh port model on the JAX model's weights, its optimizer, the
    resilient step and its live state."""
    _, params, _, _ = _jax_side(dropout)
    model = GPTModel(TransformerConfig(**TINY, hidden_dropout=dropout,
                                       attention_dropout=dropout),
                     device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    opt = FusedAdam(model.parameters(), lr=LR)
    scaler = LossScaler("dynamic")

    def loss_fn(batch, rng):
        return model(batch["tokens"], batch["labels"],
                     loss_mask=batch["loss_mask"], rng=rng,
                     deterministic=rng is None)

    step = tres.make_resilient_train_step(loss_fn, opt, scaler)
    state = tres.make_train_state(model, opt, scaler.init("cpu"))
    return model, step, state


def _cfg(pkg, **kw):
    base = dict(save_interval_steps=4, poll_interval_steps=4,
                max_consecutive_skips=2, max_to_keep=3, min_history=4,
                save_backoff_base=0.0, handle_sigterm=False)
    base.update(kw)
    return pkg.ResilienceConfig(**base)


def _compare(jr, tr, model):
    assert tr.status == jr.status
    assert tr.steps_completed == jr.steps_completed
    assert tr.rollbacks == jr.rollbacks
    jt = dict(jr.telemetry)
    jt.pop("retraces")
    tt = dict(tr.telemetry)
    assert tt.pop("retraces") == 0
    assert tt == jt
    assert [(h["step"], h["skipped"]) for h in tr.history] == \
        [(h["step"], h["skipped"]) for h in jr.history]
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in jr.history], rtol=1e-5)
    want = jax.tree_util.tree_flatten_with_path(
        jax.device_get(jr.state["params"]))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        params_to_jax(model.state_dict()))[0])
    for path, w in want:
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(w),
                                   rtol=0, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def _both(tmp_path, name, dropout=0.0, schedule=None, cfg=None,
          resume=None, damage=None, num_steps=STEPS):
    """One fault schedule through both packages (``resume``: a second
    run from a fresh state on the same directory, after ``damage(dir)``)
    and the comparison of the last run's results."""
    rng_j = jax.random.PRNGKey(5) if dropout else None
    rng_t = prng.prng_key(5) if dropout else None
    out = {}
    for pkg, faults, tag in ((jres, jfaults, "jax"), (tres, tfaults, "port")):
        d = str(tmp_path / f"{name}_{tag}")
        inj = faults.FaultInjector(**(schedule or {}))
        if pkg is jres:
            model, step, state = None, _jax_side(dropout)[2], \
                _jax_state(dropout)
            batch_fn, rng = _jax_batch, rng_j
        else:
            model, step, state = _torch_run_parts(dropout)
            batch_fn, rng = _torch_batch, rng_t
        res = pkg.run_training(step, state, batch_fn, num_steps, rng=rng,
                               checkpoint_dir=d,
                               config=_cfg(pkg, **(cfg or {})),
                               fault_injector=inj)
        first = res
        if resume is not None:
            if damage is not None:
                damage(faults, d)
            if pkg is jres:
                state = _jax_state(dropout)
            else:
                model, step, state = _torch_run_parts(dropout)
            res = pkg.run_training(step, state, batch_fn, num_steps,
                                   rng=rng, checkpoint_dir=d,
                                   config=_cfg(pkg, **(cfg or {})))
        out[tag] = (first, res, model)
    (jfirst, jres_, _), (tfirst, tres_, model) = out["jax"], out["port"]
    assert tfirst.status == jfirst.status
    assert tfirst.telemetry["steps"] == jfirst.telemetry["steps"]
    _compare(jres_, tres_, model)
    return out


def test_nan_window_rolls_back_like_jax(tmp_path):
    out = _both(tmp_path, "nan", schedule=dict(nan_grad_calls={5, 6}))
    res = out["port"][1]
    assert res.status == "completed" and res.rollbacks == 1
    assert res.telemetry["skips"] == 2 and res.telemetry["verdicts"] == 1


def test_preemption_and_resume_like_jax(tmp_path):
    out = _both(tmp_path, "pre", schedule=dict(preempt_at_call=6),
                resume=True)
    first, res, _ = out["port"]
    assert first.status == "preempted" and first.steps_completed == 6
    assert first.telemetry["emergency_saves"] == 1
    assert res.telemetry["resumes"] == 1 and res.status == "completed"


def test_save_failures_and_corrupt_newest_step_like_jax(tmp_path):
    def damage(faults, d):
        faults.corrupt_shard(d, 9, kind="bitflip")

    out = _both(tmp_path, "io",
                schedule=dict(save_failures={4: 2}, preempt_at_call=9),
                cfg=dict(save_retries=3), resume=True, damage=damage)
    first, res, _ = out["port"]
    assert first.telemetry["ckpt_save_retries"] == 2
    assert first.telemetry["ckpt_save_failures"] == 0
    assert res.telemetry["ckpt_verify_failures"] == 1
    assert res.telemetry["ckpt_deleted_corrupt"] == 1
    assert res.telemetry["resumes"] == 1


def test_dropout_replay_after_rollback_like_jax(tmp_path):
    out = _both(tmp_path, "drop", dropout=0.1,
                schedule=dict(nan_grad_calls={6, 7}))
    res = out["port"][1]
    assert res.rollbacks == 1 and res.status == "completed"


_FINITE = st.floats(min_value=0.01, max_value=50.0)
_VALUE = st.one_of(_FINITE, st.sampled_from([math.nan, math.inf,
                                             -math.inf, 1e6]))


@settings(max_examples=60, deadline=None)
@given(seq=st.lists(st.tuples(_VALUE, st.one_of(st.none(), _VALUE),
                              st.booleans()), max_size=40),
       knobs=st.tuples(st.integers(1, 4), st.integers(1, 3),
                       st.integers(1, 6), st.sampled_from([2.0, 10.0])))
def test_watchdog_verdicts_equal_jax(seq, knobs):
    skips, patience, history, factor = knobs
    kw = dict(max_consecutive_skips=skips, anomaly_patience=patience,
              min_history=history, loss_spike_factor=factor,
              grad_spike_factor=factor * 10, history_window=8)
    jw = jres.Watchdog(jres.ResilienceConfig(**kw))
    tw = tres.Watchdog(tres.ResilienceConfig(**kw))
    for i, (loss, gnorm, skipped) in enumerate(seq):
        a = jw.observe(i + 1, loss, gnorm, skipped)
        b = tw.observe(i + 1, loss, gnorm, skipped)
        assert (a is None) == (b is None)
        if a is not None:
            assert (b.reason, b.step, b.first_bad_step, b.detail) == \
                (a.reason, a.step, a.first_bad_step, a.detail)
            jw.reset()
            tw.reset()


def _port_run(tmp_path, name, schedule=None, num_steps=STEPS, **cfg):
    model, step, state = _torch_run_parts(0.0)
    res = tres.run_training(step, state, _torch_batch, num_steps,
                            checkpoint_dir=str(tmp_path / name),
                            config=_cfg(tres, **cfg),
                            fault_injector=tfaults.FaultInjector(
                                **(schedule or {})))
    return model, res


def _one_thread(fn):
    """Run ``fn`` with one CPU thread: torch's CPU GEMMs then sum in one
    order run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def test_resume_is_bitwise_an_uninterrupted_run(tmp_path):
    def runs():
        clean, _ = _port_run(tmp_path, "clean")
        _, first = _port_run(tmp_path, "run",
                             schedule=dict(preempt_at_call=7))
        assert first.status == "preempted"
        resumed, res = _port_run(tmp_path, "run")
        assert res.telemetry["resumes"] == 1
        return clean, resumed

    clean, resumed = _one_thread(runs)
    for (name, a), b in zip(clean.state_dict().items(),
                            resumed.state_dict().values()):
        assert torch.equal(a, b), name


def test_sigterm_makes_a_resumable_emergency_save(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    calls = {"n": 0}

    def batch_fn(step):
        calls["n"] += 1
        if calls["n"] == 6:
            os.kill(os.getpid(), signal.SIGTERM)
        return _torch_batch(step)

    _, step, state = _torch_run_parts(0.0)
    d = str(tmp_path / "run")
    res = tres.run_training(step, state, batch_fn, STEPS, checkpoint_dir=d,
                            config=_cfg(tres, handle_sigterm=True))
    assert res.status == "preempted"
    assert res.telemetry["emergency_saves"] == 1
    assert signal.getsignal(signal.SIGTERM) == prev
    assert ShardedCheckpointManager(d).latest_step() == res.steps_completed
    _, step, state = _torch_run_parts(0.0)
    again = tres.run_training(step, state, _torch_batch, STEPS,
                              checkpoint_dir=d, config=_cfg(tres))
    assert again.status == "completed"
    assert again.telemetry["resumes"] == 1
    assert again.steps_completed == STEPS


def test_exhausted_budget_and_no_manager_raise(tmp_path):
    with pytest.raises(tres.TrainingDiverged, match="budget exhausted"):
        _port_run(tmp_path, "budget", max_rollbacks=1,
                  schedule=dict(nan_grad_calls={5, 6, 9, 10}))
    _, step, state = _torch_run_parts(0.0)
    with pytest.raises(tres.TrainingDiverged, match="no checkpoint"):
        tres.run_training(step, state, _torch_batch, STEPS,
                          config=_cfg(tres),
                          fault_injector=tfaults.FaultInjector(
                              nan_grad_calls={1, 2}))


def test_scaler_trackers_round_trip_and_rollback_halves_the_scale(
        tmp_path):
    scaler = LossScaler("dynamic", init_scale=2.0 ** 10, scale_window=8,
                        hysteresis=3)
    state = scaler.init("cpu")
    for inf in (1, 1, 0, 0, 0, 0, 0):
        new = scaler.update(state, torch.tensor(bool(inf)))
        state = new
    mgr = ShardedCheckpointManager(str(tmp_path / "s"), fsync=False)
    mgr.save(7, {"scaler": state})
    template = {"scaler": LossScaler("dynamic").init("cpu")}
    got = mgr.restore_step(7, template)["scaler"]
    assert scaler.state_dict(got) == scaler.state_dict(state) == {
        "loss_scale": 1024.0, "growth_tracker": 5,
        "hysteresis_tracker": 1, "unskipped": 5}

    # a rollback halves the restored scale, floored at 1
    for init, want in ((2.0 ** 16, 2.0 ** 15), (1.0, 1.0)):
        _, step, live = _torch_run_parts(0.0)
        live["scaler"] = LossScaler("dynamic", init_scale=init).init("cpu")
        res = tres.run_training(step, live, _torch_batch, 6,
                                checkpoint_dir=str(tmp_path / f"r{init}"),
                                config=_cfg(tres, save_interval_steps=2,
                                            poll_interval_steps=2),
                                fault_injector=tfaults.FaultInjector(
                                    nan_grad_calls={2, 3}))
        assert res.rollbacks == 1 and res.status == "completed"
        sc = res.state["scaler"]
        assert float(sc.loss_scale) == want
        assert int(sc.growth_tracker) == int(sc.unskipped) == 4


def test_monitor_reconciles_with_telemetry(tmp_path, capsys):
    from apex_tpu_torch.monitor import main as monitor_main

    jsonl = str(tmp_path / "run.jsonl")
    reg = MetricsRegistry([JsonlSink(jsonl)])
    _, res = _port_run(tmp_path, "mon", schedule=dict(nan_grad_calls={5, 6}),
                       metrics=reg)
    reg.close()
    assert res.telemetry["rollbacks"] == 1
    report = build_report(jsonl)
    assert report["counters"] == res.telemetry
    ckpt = report["checkpoints"]
    for event, counter in CHECKPOINT_INCIDENT_COUNTERS.items():
        assert ckpt["counts"].get(event, 0) == \
            report["counters"].get(counter, 0), (event, counter)
    assert ckpt["timings"]["ckpt_write_s"]["count"] >= 1
    assert ckpt["timings"]["ckpt_snapshot_blocked_s"]["count"] >= 1
    assert "checkpoints:" in render_report(report)
    assert monitor_main([jsonl]) == 0
    assert "checkpoints:" in capsys.readouterr().out


@pytest.mark.slow
def test_bf16_compute_rollback_matches_jax_to_tolerance(tmp_path):
    """Scenario (a) with bf16 compute over fp32 params: the packages round
    bf16 at other points (tests/test_torch_gpt_training.py), so the
    losses agree to rtol 2e-2; flags and telemetry are exact."""
    cfg = dict(**TINY, compute_dtype=None)
    jm = JaxGPT(JaxConfig(**dict(cfg, compute_dtype=jnp.bfloat16)))
    params = jm.init(jax.random.PRNGKey(3))
    jscaler = JaxLossScaler("dynamic")
    jstep = jres.make_resilient_train_step(
        lambda p, b, r: jm.apply(p, b["tokens"], b["labels"],
                                 loss_mask=b["loss_mask"]),
        JaxFusedAdam(lr=LR), jscaler)
    fresh = jax.tree.map(jnp.array, params)     # the step donates its state
    jstate = jres.make_train_state(fresh, JaxFusedAdam(lr=LR).init(fresh),
                                   jscaler.init())
    sched = dict(nan_grad_calls={5, 6})
    jr = jres.run_training(jstep, jstate, _jax_batch, STEPS,
                           checkpoint_dir=str(tmp_path / "j"),
                           config=_cfg(jres),
                           fault_injector=jfaults.FaultInjector(**sched))
    model = GPTModel(TransformerConfig(**dict(
        cfg, compute_dtype=torch.bfloat16)), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    opt = FusedAdam(model.parameters(), lr=LR)
    scaler = LossScaler("dynamic")
    step = tres.make_resilient_train_step(
        lambda b, r: model(b["tokens"], b["labels"],
                           loss_mask=b["loss_mask"]), opt, scaler)
    tr = tres.run_training(step, tres.make_train_state(
        model, opt, scaler.init("cpu")), _torch_batch, STEPS,
        checkpoint_dir=str(tmp_path / "t"), config=_cfg(tres),
        fault_injector=tfaults.FaultInjector(**sched))
    assert (tr.status, tr.steps_completed, tr.rollbacks) == \
        (jr.status, jr.steps_completed, jr.rollbacks)
    jt = {k: v for k, v in jr.telemetry.items() if k != "retraces"}
    assert {k: v for k, v in tr.telemetry.items() if k != "retraces"} == jt
    assert [(h["step"], h["skipped"]) for h in tr.history] == \
        [(h["step"], h["skipped"]) for h in jr.history]
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in jr.history], rtol=2e-2)
