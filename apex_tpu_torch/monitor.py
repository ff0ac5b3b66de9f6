"""``python -m apex_tpu_torch.monitor <run.jsonl>`` — the run-report CLI.

Reads the JSONL metric log a
:class:`apex_tpu_torch.observability.JsonlSink`-equipped run wrote and prints
the report: telemetry counter totals (reconciling exactly with the
run's ``TrainingResult.telemetry``), step-time p50/p95, throughput/MFU
trajectory, the serving-request section (per-request latency quantiles
and finish-reason counts from an ``InferenceEngine``'s
``kind="request"`` rows, reconciling with its ``requests_*`` counters),
the serving-incidents section (engine restarts, recovered requests,
quarantined slots, breaker transitions, shed requests — reconciling
key-for-key with the supervisor's counters), and the incident timeline
(skips, rollbacks, retraces, preemptions). ``--json`` emits the raw
report dict instead.

Thin shim over :mod:`apex_tpu_torch.observability.report` so the command
reads ``apex_tpu_torch.monitor`` while the logic lives with the subsystem.
"""

from apex_tpu_torch.observability.report import (  # noqa: F401
    build_report,
    read_records,
    render_report,
    main,
)

__all__ = ["build_report", "read_records", "render_report", "main"]

if __name__ == "__main__":
    import sys

    sys.exit(main())
