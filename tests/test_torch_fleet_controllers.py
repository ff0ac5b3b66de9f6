"""The port's fleet controllers against the JAX package's, decision for
decision, on the same recorded signal and load sequences (no engine, no
model: stub replicas and scripted signals).

Held here, each over several seeded sequences:

- ``Router``: the cost of a replica (depth x EWMA, the token-aware
  surcharge, an unmeasured replica at 0), the prefix-affinity share over
  the same dispatch history, the pick, and ``invalidate``; the prefix hash
  chains the router keys affinity on equal JAX's;
- ``Autoscaler``: ``desired_direction`` for every signals dict, and
  ``maybe_scale`` over a scripted stream (hysteresis, cooldown, bounds,
  topology and deployment holds): the same decisions at the same times,
  the same ``kind="autoscale"`` records, and the same retire targets;
- ``BrownoutController``: the rung after every poll, the transitions and
  their records, the admission floors asserted, the batch slots preempted
  at the preempt rung, and ``clamp`` of each request;
- ``QuotaLedger``: the verdict (admit, defer, shed and the limit), the
  bucket level, inflight and pages of every tenant after each submit,
  commit and release;
- ``DriftSentinel``: the anomalies ``observe`` fires for each sample, and
  ``maybe_poll``'s anomaly and gauge-snapshot records and counters;
- ``FleetMetrics``: ``signals()`` (the window fields aside from
  ``window_s``, a host-clock interval), ``snapshot()``, the labeled
  gauges and histograms and the Prometheus textfile over the same
  per-replica registry events.
"""

import numpy as np
import pytest

from apex_tpu.observability import MetricsRegistry as JRegistry
from apex_tpu.observability.fleet_metrics import FleetMetrics as JFleetMetrics
from apex_tpu.observability.fleet_metrics import \
    ReplicaRegistry as JReplicaRegistry
from apex_tpu.observability.sentinel import DriftSentinel as JSentinel
from apex_tpu.observability.sentinel import SentinelConfig as JSentinelConfig
from apex_tpu.serving import Request as JRequest
from apex_tpu.serving import SamplingParams as JSampling
from apex_tpu.serving.fleet import AutoscaleConfig as JAutoscaleConfig
from apex_tpu.serving.fleet import Autoscaler as JAutoscaler
from apex_tpu.serving.fleet import BrownoutConfig as JBrownoutConfig
from apex_tpu.serving.fleet import BrownoutController as JBrownout
from apex_tpu.serving.fleet import QuotaConfig as JQuotaConfig
from apex_tpu.serving.fleet import QuotaLedger as JQuotaLedger
from apex_tpu.serving.fleet import Router as JRouter
from apex_tpu.serving.fleet import TenantQuota as JTenantQuota
from apex_tpu.serving.fleet import router as jrouter
from apex_tpu.serving.prefix import prefix_hash_chain as jchain
from apex_tpu_torch.observability import (DriftSentinel, FleetMetrics,
                                          MetricsRegistry, ReplicaRegistry,
                                          SentinelConfig)
from apex_tpu_torch.serving import Request, SamplingParams
from apex_tpu_torch.serving.fleet import (AutoscaleConfig, Autoscaler,
                                          BrownoutConfig, BrownoutController,
                                          QuotaConfig, QuotaLedger, Router,
                                          TenantQuota)
from apex_tpu_torch.serving.fleet import router as trouter
from apex_tpu_torch.serving.prefix import prefix_hash_chain

SEEDS = range(4)

#: the two packages' sides of every comparison
SIDES = {
    "port": dict(router=trouter, Router=Router, Autoscaler=Autoscaler,
                 AutoscaleConfig=AutoscaleConfig,
                 Brownout=BrownoutController, BrownoutConfig=BrownoutConfig,
                 QuotaLedger=QuotaLedger, QuotaConfig=QuotaConfig,
                 TenantQuota=TenantQuota, Sentinel=DriftSentinel,
                 SentinelConfig=SentinelConfig, Registry=MetricsRegistry,
                 ReplicaRegistry=ReplicaRegistry, FleetMetrics=FleetMetrics,
                 Request=Request, Sampling=SamplingParams,
                 chain=prefix_hash_chain),
    "jax": dict(router=jrouter, Router=JRouter, Autoscaler=JAutoscaler,
                AutoscaleConfig=JAutoscaleConfig,
                Brownout=JBrownout, BrownoutConfig=JBrownoutConfig,
                QuotaLedger=JQuotaLedger, QuotaConfig=JQuotaConfig,
                TenantQuota=JTenantQuota, Sentinel=JSentinel,
                SentinelConfig=JSentinelConfig, Registry=JRegistry,
                ReplicaRegistry=JReplicaRegistry,
                FleetMetrics=JFleetMetrics, Request=JRequest,
                Sampling=JSampling, chain=jchain),
}


class _Sink:
    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)

    def flush(self):
        pass

    def typed(self, kind):
        """Records of one kind without their clock stamps."""
        return [{k: v for k, v in r.items() if k not in ("wall", "ts",
                                                         "seq")}
                for r in self.records if r.get("kind") == kind]


class _Engine:
    def __init__(self, by_class):
        self.by_class = by_class

    def queued_depth_by_class(self):
        return dict(self.by_class)


class _Sup:
    """A supervisor's load surface, scripted."""

    def __init__(self, queued, active, service, excess=0.0, tokens=0,
                 by_class=None):
        self.queued_count = queued
        self.active_count = active
        self.service_estimate_s = service
        self.queued_token_excess_s = excess
        self.queued_prompt_tokens = tokens
        self.engine = _Engine(by_class or {})
        self.floors = []
        self.preempted = []

    def set_admission_floor(self, priority):
        self.floors.append(priority)

    def preempt_class(self, priority, *, cause="brownout"):
        self.preempted.append((priority, cause))
        return self.queued_count % 3


def _replica(side, rid, sup):
    mod = SIDES[side]["router"]
    r = mod._Replica.__new__(mod._Replica)
    r.replica_id, r.supervisor = rid, sup
    r.state = mod.REPLICA_ACTIVE
    r.dispatches, r.probe_id, r.probe_attempts = 0, None, 0
    r.retire_on_drain = False
    return r


def _loads(rng, n):
    return [dict(queued=int(rng.randint(0, 6)),
                 active=int(rng.randint(0, 3)),
                 service=(None if rng.rand() < 0.2
                          else float(rng.choice([0.05, 0.1, 0.25, 0.5]))),
                 excess=float(rng.choice([0.0, 0.0, 0.125, 0.5])))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# Router


@pytest.mark.parametrize("seed", SEEDS)
def test_router_cost_affinity_and_pick_like_jax(seed):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, 50, size=int(rng.randint(3, 40))).tolist()
               for _ in range(12)]
    # shared prefixes, so affinity has runs to find
    prompts += [prompts[i][:8] + rng.randint(0, 50, size=9).tolist()
                for i in range(6)]
    chains = {}
    for side in SIDES:
        chains[side] = [SIDES[side]["chain"](p, 4, "salt") or None
                        for p in prompts]
    assert chains["port"] == chains["jax"]
    routers = {side: SIDES[side]["Router"](affinity_weight=0.3,
                                           residency_capacity=4)
               for side in SIDES}
    picks = {side: [] for side in SIDES}
    for step in range(40):
        loads = _loads(rng, 3)
        ix = int(rng.randint(len(prompts)))
        invalidate = int(rng.randint(3)) if rng.rand() < 0.1 else None
        for side in SIDES:
            router = routers[side]
            reps = [_replica(side, i, _Sup(**kw))
                    for i, kw in enumerate(loads)]
            chain = chains[side][ix]
            got = router.pick(reps, chain=chain)
            picks[side].append((
                got.replica_id,
                [router.cost(r) for r in reps],
                [router.affinity(r.replica_id, chain) for r in reps]))
            router.note_dispatch(got.replica_id, chain)
            if invalidate is not None:
                router.invalidate(invalidate)
    assert picks["port"] == picks["jax"]
    assert len({p[0] for p in picks["port"]}) > 1


def test_router_rejects_like_jax():
    for side in SIDES:
        with pytest.raises(ValueError, match="no candidates"):
            SIDES[side]["Router"]().pick([])
        with pytest.raises(ValueError, match="affinity_weight"):
            SIDES[side]["Router"](affinity_weight=1.0)


# ---------------------------------------------------------------------------
# Autoscaler


def _signals(rng):
    return {"replicas_total": int(rng.randint(1, 4)),
            "replicas_dispatchable": int(rng.randint(0, 4)),
            "queue_depth": int(rng.choice([0, 0, 1, 2, 5, 9, 20])),
            "queued_tokens": int(rng.choice([0, 30, 300, 3000])),
            "inflight": int(rng.randint(0, 9)),
            "goodput_window": float(rng.choice([0.0, 0.5, 0.9, 1.0])),
            "window_terminal": int(rng.choice([0, 0, 3])),
            "window_s": 0.1,
            "ttft_p99_s": (None if rng.rand() < 0.3
                           else float(rng.choice([0.01, 0.2, 2.0]))),
            "slot_occupancy": (None if rng.rand() < 0.2
                               else float(rng.choice([0.0, 0.2, 1.0])))}


class _Scripted:
    def __init__(self, fleet, script):
        self.fleet = fleet
        self._script = list(script)

    def signals(self):
        if len(self._script) > 1:
            return self._script.pop(0)
        return self._script[0]


class _PolicyFleet:
    def __init__(self, side, depths):
        self.side = side
        self.sink = _Sink()
        self.metrics = SIDES[side]["Registry"](sinks=[self.sink])
        self.replicas = [_replica(side, i, _Sup(d, 0, 0.01))
                         for i, d in enumerate(depths)]
        self.topology_busy = None
        self.deployment = None
        self._backlog = []

    @property
    def n_replicas(self):
        return len(self.replicas)

    def add_replica(self):
        rid = max((r.replica_id for r in self.replicas), default=-1) + 1
        self.replicas.append(_replica(self.side, rid, _Sup(0, 0, 0.01)))
        return rid

    def retire_replica(self, rid):
        self.replicas = [r for r in self.replicas if r.replica_id != rid]


AUTOSCALE_CONFIGS = [
    dict(min_replicas=1, max_replicas=3, poll_interval_s=0.1,
         cooldown_s=0.5, hysteresis_polls=2,
         scale_up_queue_per_replica=2.0),
    dict(min_replicas=1, max_replicas=4, poll_interval_s=0.05,
         cooldown_s=0.2, hysteresis_polls=1, scale_up_queue_per_replica=0.0,
         scale_up_queued_tokens_per_replica=500.0, scale_up_goodput=0.8,
         scale_up_ttft_p99_s=1.0, scale_down_queue_per_replica=1.0,
         scale_down_slot_occupancy=0.5),
]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cfg", range(len(AUTOSCALE_CONFIGS)))
def test_autoscaler_decides_like_jax(seed, cfg):
    rng = np.random.RandomState(seed)
    script = [_signals(rng) for _ in range(60)]
    times = np.cumsum(rng.choice([0.03, 0.06, 0.12, 0.3], size=60))
    busy = rng.rand(60) < 0.1
    rolling = rng.rand(60) < 0.05
    depths = rng.randint(0, 4, size=2).tolist()
    out = {}
    for side in SIDES:
        scaler = SIDES[side]["Autoscaler"](
            SIDES[side]["AutoscaleConfig"](**AUTOSCALE_CONFIGS[cfg]))
        direction = [scaler.desired_direction(s) for s in script]
        fleet = _PolicyFleet(side, depths)
        scaler._fm = _Scripted(fleet, [dict(s) for s in script])
        applied = []
        for t, b, d in zip(times, busy, rolling):
            fleet.topology_busy = 0 if b else None
            fleet.deployment = type("D", (), {"done": not d})()
            applied.append(scaler.maybe_scale(fleet, now=float(t)))
        out[side] = (direction, applied, scaler.decisions,
                     [r.replica_id for r in fleet.replicas],
                     fleet.sink.typed("autoscale"),
                     scaler._streak, scaler._streak_dir)
    assert out["port"] == out["jax"]
    assert any(a is not None for a in out["port"][1])


@pytest.mark.parametrize("seed", SEEDS)
def test_autoscaler_retire_target_like_jax(seed):
    rng = np.random.RandomState(seed)
    targets = {side: [] for side in SIDES}
    for _ in range(20):
        depths = rng.randint(0, 3, size=int(rng.randint(1, 5))).tolist()
        draining = rng.rand(len(depths)) < 0.2
        for side in SIDES:
            fleet = _PolicyFleet(side, depths)
            for r, d in zip(fleet.replicas, draining):
                if d:
                    r.state = SIDES[side]["router"].REPLICA_DRAINING
            targets[side].append(
                SIDES[side]["Autoscaler"]._retire_target(fleet))
    assert targets["port"] == targets["jax"]
    assert any(t is not None for t in targets["port"])


def test_autoscale_config_rejects_like_jax():
    bad = [dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
           dict(poll_interval_s=0.0), dict(cooldown_s=-1.0),
           dict(hysteresis_polls=0), dict(scale_up_goodput=1.5),
           dict(scale_down_queue_per_replica=5.0)]
    for kw in bad:
        errors = []
        for side in SIDES:
            with pytest.raises(ValueError) as info:
                SIDES[side]["AutoscaleConfig"](**kw)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# Brownout ladder


def _requests(side, rng, n):
    mods = SIDES[side]
    out = []
    for i in range(n):
        pri = ("interactive", "standard", "batch")[int(rng.randint(3))]
        out.append(mods["Request"](
            prompt=[1, 2, 3], max_new_tokens=int(rng.randint(1, 40)),
            sampling=mods["Sampling"](priority=pri), request_id=10_000 + i,
            deadline_s=2.0))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_brownout_rungs_like_jax(seed):
    rng = np.random.RandomState(seed)
    n = 80
    script = []
    level = 0.0
    for _ in range(n):
        level = max(0.0, level + float(rng.choice([-4, -2, 0, 2, 4, 6])))
        script.append({"queue_depth": int(level),
                       "replicas_dispatchable": int(rng.randint(1, 3))})
    held = [{"batch": int(rng.randint(0, 4)),
             "standard": int(rng.randint(0, 3)), "interactive": 0}
            for _ in range(n)]
    times = np.cumsum(rng.choice([0.05, 0.1, 0.2], size=n))
    cfg = dict(poll_interval_s=0.1, queue_depth_high=6.0,
               queue_depth_low=2.0, hot_polls=2, cool_polls=2,
               clamp_max_new_tokens=8)
    out = {}
    for side in SIDES:
        mods = SIDES[side]
        ctl = mods["Brownout"](mods["BrownoutConfig"](**cfg))
        fleet = _PolicyFleet(side, [3, 5])
        ctl._fm = _Scripted(fleet, [dict(s) for s in script])
        rungs, clamps = [], []
        reqs = _requests(side, np.random.RandomState(seed + 100), n)
        for t, h, req in zip(times, held, reqs):
            for r in fleet.replicas:
                r.supervisor.engine.by_class = h
            rungs.append((ctl.maybe_step(fleet, now=float(t)), ctl.rung,
                          ctl.rung_name, ctl.admission_floor()))
            c = ctl.clamp(req)
            clamps.append((c is req, c.max_new_tokens, c.request_id,
                           c.deadline_s, c.trace_id == req.trace_id))
        out[side] = (rungs, clamps, ctl.transitions,
                     fleet.sink.typed("brownout"),
                     fleet.metrics.counters(),
                     [(r.supervisor.floors, r.supervisor.preempted)
                      for r in fleet.replicas])
    assert out["port"] == out["jax"]
    assert max(r[1] for r in out["port"][0]) >= 2


# ---------------------------------------------------------------------------
# Quotas


@pytest.mark.parametrize("seed", SEEDS)
def test_quota_ledger_like_jax(seed):
    rng = np.random.RandomState(seed)
    tenants = {"0": dict(rate_rps=2.0, burst=2.0, max_inflight=2),
               "1": dict(rate_rps=0.0, max_pages=12, soft=True),
               "2": dict(rate_rps=5.0, burst=1.0, soft=True)}
    default = dict(max_inflight=3)
    names = ["0", "1", "2", "base", "other"]
    ops = []
    t = 0.0
    for _ in range(150):
        t += float(rng.choice([0.0, 0.05, 0.2, 0.6]))
        ops.append((t, names[int(rng.randint(len(names)))],
                    int(rng.randint(0, 6)), rng.rand()))
    out = {}
    for side in SIDES:
        mods = SIDES[side]
        ledger = mods["QuotaLedger"](mods["QuotaConfig"](
            tenants={k: mods["TenantQuota"](**v)
                     for k, v in tenants.items()},
            default=mods["TenantQuota"](**default)))
        held = []
        trace = []
        for now, tenant, pages, u in ops:
            if held and u < 0.35:
                ten, pg = held.pop(int(u * 1000) % len(held))
                ledger.release(ten, pages=pg)
                trace.append(("release", ten))
                continue
            verdict = ledger.verdict(tenant, now, pages=pages)
            if verdict[0] == "admit":
                ledger.commit(tenant, now, pages=pages)
                held.append((tenant, pages))
            trace.append((verdict, ledger.bucket_tokens(tenant, now),
                          ledger.inflight(tenant),
                          ledger.pages_held(tenant)))
        req = mods["Request"](prompt=[1], max_new_tokens=1,
                              sampling=mods["Sampling"](adapter_id="7"))
        out[side] = (trace, mods["QuotaLedger"].tenant(req))
    assert out["port"] == out["jax"]
    verdicts = {t[0][0] for t in out["port"][0] if t[0] != "release"}
    assert verdicts == {"admit", "defer", "shed"}


def test_tenant_quota_rejects_like_jax():
    for kw in (dict(rate_rps=-1.0), dict(burst=0.5), dict(max_inflight=-1),
               dict(max_pages=-2)):
        errors = []
        for side in SIDES:
            with pytest.raises(ValueError) as info:
                SIDES[side]["TenantQuota"](**kw)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# Drift sentinel


SENTINEL = dict(poll_interval_s=0.02, warmup_polls=5, ewma_alpha=0.05,
                z_threshold=4.0, hysteresis_polls=2, cooldown_s=1.0,
                min_abs_dev=0.5, snapshot_every_polls=5,
                signals=("queue_depth", "ttft_p99_s", "goodput_window"))


def _drift_script(rng, n):
    out = []
    for i in range(n):
        surge = 30 <= i < 60 or 100 <= i < 115
        out.append({
            "queue_depth": float(rng.poisson(12 if surge else 1)),
            "ttft_p99_s": (None if rng.rand() < 0.1
                           else float(0.05 + 0.5 * surge
                                      + 0.01 * rng.rand())),
            "goodput_window": float(0.6 if surge and rng.rand() < 0.5
                                    else 1.0),
            "inflight": int(rng.randint(0, 5)),
            "slot_occupancy": float(rng.rand())})
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_sentinel_anomalies_like_jax(seed):
    rng = np.random.RandomState(seed)
    script = _drift_script(rng, 140)
    times = np.cumsum(rng.choice([0.01, 0.03, 0.05], size=140))
    out = {}
    for side in SIDES:
        mods = SIDES[side]
        pure = mods["Sentinel"](mods["SentinelConfig"](**SENTINEL))
        fired = [pure.observe(dict(s), float(t))
                 for s, t in zip(script, times)]
        polled = mods["Sentinel"](mods["SentinelConfig"](**SENTINEL))
        fleet = _PolicyFleet(side, [0, 1])
        fleet.metrics.set_gauge("kv_pages_free", 3.0)
        polled._fm = _Scripted(fleet, [dict(s) for s in script])
        polled._fm.labeled_gauges = lambda: {"kv_pages_free": 3.0}
        polls = [polled.maybe_poll(fleet, float(t)) for t in times]
        out[side] = (fired, polls, pure.polls, polled.polls,
                     fleet.sink.typed("anomaly"),
                     fleet.sink.typed("gauge_snapshot"),
                     fleet.metrics.counters())
    assert out["port"] == out["jax"]
    assert sum(len(f) for f in out["port"][0]) >= 1


def test_sentinel_config_rejects_like_jax():
    for kw in (dict(poll_interval_s=0.0), dict(warmup_polls=0),
               dict(ewma_alpha=0.0), dict(z_threshold=0.0),
               dict(hysteresis_polls=0), dict(cooldown_s=-1.0),
               dict(min_abs_dev=0.0), dict(snapshot_every_polls=-1),
               dict(signals=())):
        errors = []
        for side in SIDES:
            with pytest.raises(ValueError) as info:
                SIDES[side]["SentinelConfig"](**kw)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# FleetMetrics


class _MetricsFleet:
    """The surface FleetMetrics reads: a registry, per-replica views, live
    replicas, the dispatch set, inflight and the backlog."""

    def __init__(self, side, n, max_slots):
        mods = SIDES[side]
        self.metrics = mods["Registry"]()
        self.replica_metrics = {i: mods["ReplicaRegistry"](self.metrics, i)
                                for i in range(n)}
        self.retired_replica_metrics = {}
        self.replicas = [_replica(side, i, _Sup(0, 0, None))
                         for i in range(n)]
        self.config = type("C", (), {"max_slots": max_slots})()
        self.inflight_count = 0
        self._backlog = []
        self.open = set()

    def dispatch_set(self):
        return [r for r in self.replicas if r.replica_id not in self.open]


REASONS = ("eos", "length", "cancelled", "timeout", "rejected", "error")


def _events(rng, n):
    out = []
    for _ in range(n):
        kind = rng.choice(["inc", "observe", "gauge", "load", "retire"],
                          p=[0.4, 0.3, 0.15, 0.13, 0.02])
        rid = int(rng.randint(3))
        if kind == "inc":
            name = rng.choice([f"requests_{r}" for r in REASONS]
                              + ["requests_submitted", "adapter0_requests",
                                 "adapter2_requests", "decode_steps"])
            out.append(("inc", rid, str(name), int(rng.randint(1, 3))))
        elif kind == "observe":
            name = rng.choice(["request_ttft_s", "request_tpot_s",
                               "spec_accept_rate", "request_total_s"])
            out.append(("observe", rid, str(name), float(rng.rand())))
        elif kind == "gauge":
            name = rng.choice(["kv_pages_in_use", "kv_pages_free",
                               "slots_active"])
            out.append(("gauge", rid, str(name), float(rng.randint(0, 40))))
        elif kind == "load":
            out.append(("load", rid, (int(rng.randint(0, 5)),
                                      int(rng.randint(0, 3)),
                                      int(rng.randint(0, 400))),
                        (int(rng.randint(0, 6)),
                         int(rng.randint(0, 3)) == 0)))
        else:
            out.append(("retire", rid, None, None))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_metrics_signals_like_jax(seed, tmp_path):
    rng = np.random.RandomState(seed)
    events = _events(rng, 200)
    out = {}
    for side in SIDES:
        fleet = _MetricsFleet(side, 3, max_slots=4)
        fm = SIDES[side]["FleetMetrics"](fleet)
        polls = []
        for i, (kind, rid, name, value) in enumerate(events):
            reg = fleet.replica_metrics.get(rid)
            if kind == "retire":
                if reg is not None and len(fleet.replicas) > 1:
                    fleet.retired_replica_metrics[rid] = \
                        fleet.replica_metrics.pop(rid)
                    fleet.replicas = [r for r in fleet.replicas
                                      if r.replica_id != rid]
                continue
            if reg is None:
                continue
            if kind == "inc":
                reg.inc(name, value)
            elif kind == "observe":
                reg.observe(name, value)
            elif kind == "gauge":
                reg.set_gauge(name, value)
            else:
                sup = [r for r in fleet.replicas
                       if r.replica_id == rid][0].supervisor
                (sup.queued_count, sup.active_count,
                 sup.queued_prompt_tokens) = name
                fleet.inflight_count, closed = value
                fleet.open = set() if closed else {rid}
                fleet._backlog = [None] * (i % 3)
            if i % 17 == 0:
                sig = fm.signals()
                sig.pop("window_s")
                polls.append(sig)
        path = tmp_path / f"{side}.prom"
        fm.write_prometheus(str(path))
        out[side] = (polls, fm.snapshot(), fm.labeled_gauges(),
                     {k: v.as_dict()
                      for k, v in fm.labeled_histograms().items()},
                     fm.replica_counters(), fm.merged_counters(),
                     path.read_text())
    assert out["port"] == out["jax"]
    assert any(p["goodput"] is not None for p in out["port"][0])
