"""apex_tpu_torch.loadtest — scenario-driven load testing and the SLO gate
(counterpart of ``apex_tpu.loadtest``).

A declarative :class:`Scenario` (traffic phases, mixes, deadlines, fault
schedule, declared SLOs; the JSON schema of the JAX package's, so a
scenario file means the same thing to both) is materialized by a seeded
open-loop :class:`TrafficGenerator`, replayed by :func:`run_scenario`
against the port's engine under an
:class:`~apex_tpu_torch.serving.EngineSupervisor`, scored by
:mod:`apex_tpu_torch.observability.slo`, and gated against a baseline
(:mod:`~apex_tpu_torch.loadtest.gate`).

CLI: ``python -m apex_tpu_torch.loadtest scenario.json`` runs and prints
the verdict; ``--check`` turns it into a regression gate (nonzero exit on
SLO violation or baseline regression); ``--from-log`` re-scores an
existing run log without running anything.
"""

from apex_tpu_torch.loadtest.gate import (
    DEFAULT_BASELINE,
    Regression,
    compare_to_baseline,
    load_baseline,
    update_baseline,
)
from apex_tpu_torch.loadtest.generator import ScheduledRequest, TrafficGenerator
from apex_tpu_torch.loadtest.runner import ScenarioRun, build_model, run_scenario
from apex_tpu_torch.loadtest.scenario import (
    EngineKnobs,
    FaultSchedule,
    FleetSpec,
    LoadPhase,
    ModelSpec,
    RecorderSpec,
    Scenario,
    SentinelSpec,
)

__all__ = [
    "Scenario",
    "LoadPhase",
    "ModelSpec",
    "EngineKnobs",
    "FaultSchedule",
    "FleetSpec",
    "SentinelSpec",
    "RecorderSpec",
    "TrafficGenerator",
    "ScheduledRequest",
    "ScenarioRun",
    "build_model",
    "run_scenario",
    "DEFAULT_BASELINE",
    "Regression",
    "load_baseline",
    "update_baseline",
    "compare_to_baseline",
]
