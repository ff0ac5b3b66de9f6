"""``python -m apex_tpu_torch.loadtest`` — run scenarios, score SLOs, gate.

Usage:

  python -m apex_tpu_torch.loadtest scenario.json            # run + verdict
  python -m apex_tpu_torch.loadtest --check scenario.json    # regression gate
  python -m apex_tpu_torch.loadtest --check scenario.json --from-log run.jsonl
  python -m apex_tpu_torch.loadtest scenario.json --update-baseline
  python -m apex_tpu_torch.loadtest scenario.json --dtype bf16 --out run.jsonl

``--dtype`` and ``--device`` are the port's own: the scenario's model
computes in fp32 on the card unless asked otherwise (``--device cpu``
runs the plain path).

Exit codes (gate semantics — wire them straight into CI):

  0  SLOs met; no baseline regression (or informational run)
  1  SLO violation (a declared objective failed)
  2  regression beyond tolerance against the committed baseline
  3  --check requested but the baseline has no entry for this scenario
     (run once with --update-baseline to set the bar)
  4  usage / IO / scenario-schema error

``--from-log`` re-scores an existing JSONL run log instead of running
the scenario — no model runs and no device is touched, so a log written
on a GPU host gates anywhere. Without it the scenario is executed locally
(``--out`` keeps the run log for ``python -m apex_tpu_torch.monitor``).

Copied from ``apex_tpu/loadtest/__main__.py`` (stdlib only), so the port never imports
the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from apex_tpu_torch.loadtest.gate import (
    DEFAULT_BASELINE,
    compare_to_baseline,
    load_baseline,
    update_baseline,
)
from apex_tpu_torch.loadtest.scenario import Scenario
from apex_tpu_torch.observability.report import read_records
from apex_tpu_torch.observability.slo import (
    SLOSpec,
    evaluate_slos,
    measure_slo_metrics,
)
from apex_tpu_torch.observability.trace import check_span_conservation

#: ``--dtype`` names: the model's compute dtype
DTYPES = {"f32": "float32", "bf16": "bfloat16", "fp16": "float16"}

EXIT_OK = 0
EXIT_SLO_VIOLATION = 1
EXIT_REGRESSION = 2
EXIT_NO_BASELINE = 3
EXIT_ERROR = 4


def _fmt(value: Optional[float]) -> str:
    return "(no data)" if value is None else f"{value:.6g}"


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.loadtest",
        description="Run a load-test scenario against the supervised "
                    "serving engine and score it against its declared "
                    "SLOs and the committed regression baseline "
                    "(docs/loadtest.md).")
    parser.add_argument("scenario", help="path to the scenario .json")
    parser.add_argument("--check", action="store_true",
                        help="gate mode: exit 1 on SLO violation, 2 on "
                             "baseline regression, 3 on missing baseline")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE,
                        metavar="PATH",
                        help=f"baseline file (default {DEFAULT_BASELINE})")
    parser.add_argument("--tolerance", type=float, default=None,
                        help="relative regression tolerance (default: the "
                             "scenario's own 'tolerance' field)")
    parser.add_argument("--update-baseline", action="store_true",
                        help="write this run's measured metrics into the "
                             "baseline (skips the regression check)")
    parser.add_argument("--from-log", metavar="RUN.jsonl", default=None,
                        help="score an existing run log instead of "
                             "executing the scenario (no model run)")
    parser.add_argument("--out", metavar="RUN.jsonl", default=None,
                        help="write the run's JSONL log here (monitor-"
                             "compatible)")
    parser.add_argument("--json", action="store_true",
                        help="emit the verdict as JSON instead of text")
    # the port's own: the scenario's model is fp32 as in the JAX package
    # unless asked otherwise, and runs on the card unless asked otherwise
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="f32",
                        help="compute dtype of the scenario's model "
                             "(default f32; parameters stay fp32)")
    parser.add_argument("--device", default="cuda",
                        help="device the model and engine run on "
                             "(default cuda; cpu runs the plain path)")
    args = parser.parse_args(argv)

    try:
        scenario = Scenario.load(args.scenario)
    except (OSError, ValueError, KeyError) as exc:
        print(f"apex_tpu_torch.loadtest: bad scenario {args.scenario}: {exc}",
              file=sys.stderr)
        return EXIT_ERROR
    tolerance = args.tolerance if args.tolerance is not None \
        else scenario.tolerance

    run = None
    if args.from_log is not None:
        try:
            records = read_records(args.from_log)
        except OSError as exc:
            print(f"apex_tpu_torch.loadtest: cannot read {args.from_log}: {exc}",
                  file=sys.stderr)
            return EXIT_ERROR
    else:
        # the only branch that touches torch — deferred so gating a log
        # works on hosts without an accelerator stack
        from apex_tpu_torch.loadtest.runner import build_model, run_scenario

        model = build_model(scenario.model, device=args.device,
                            compute_dtype=DTYPES[args.dtype])
        run = run_scenario(scenario, model=model, log_path=args.out)
        records = run.records

    slo_report = (evaluate_slos(records, SLOSpec.from_dict(scenario.slo))
                  if scenario.slo else None)
    metrics = (dict(slo_report.metrics) if slo_report is not None
               else measure_slo_metrics(records))

    verdict = {
        "scenario": scenario.name,
        "seed": scenario.seed,
        "requests": sum(1 for r in records
                        if r.get("kind") == "request"),
        "slo": slo_report.as_dict() if slo_report else None,
        "metrics": metrics,
        "regressions": [],
        "exit": EXIT_OK,
    }
    if run is not None:
        verdict["wall_s"] = run.wall_s
        verdict["aborted"] = run.aborted
        verdict["engine_restarts"] = run.engine_restarts

    code = EXIT_OK
    if args.update_baseline:
        entry = update_baseline(args.baseline, scenario.name, metrics)
        verdict["baseline_written"] = entry
    elif args.check:
        try:
            baseline = load_baseline(args.baseline)
        except FileNotFoundError:
            baseline = {}
        except (OSError, ValueError) as exc:
            print(f"apex_tpu_torch.loadtest: bad baseline {args.baseline}: "
                  f"{exc}", file=sys.stderr)
            return EXIT_ERROR
        entry = baseline.get(scenario.name)
        if entry is None:
            code = EXIT_NO_BASELINE
        else:
            regressions = compare_to_baseline(metrics, entry, tolerance)
            verdict["regressions"] = [r.describe() for r in regressions]
            if regressions:
                code = EXIT_REGRESSION
    # SLO violation outranks everything: a run that fails its declared
    # objectives is red regardless of baseline state
    if args.check and slo_report is not None and not slo_report.ok:
        code = EXIT_SLO_VIOLATION
    # ...except broken telemetry: a traced run whose span timelines do
    # not reconcile with its request records cannot be trusted to have
    # measured ANY of the above, so conservation failures outrank even
    # the SLO verdict. Vacuous on pre-tracing logs (no trace_id rows).
    if args.check:
        span_violations = check_span_conservation(records)
        verdict["span_violations"] = span_violations
        if span_violations:
            code = EXIT_ERROR
    verdict["exit"] = code

    if args.json:
        print(json.dumps(verdict, indent=2, default=str))
    else:
        _render(verdict, scenario, tolerance, args, code)
    return code


def _render(verdict: dict, scenario: Scenario, tolerance: float,
            args, code: int) -> None:
    print(f"== apex_tpu_torch loadtest: {scenario.name} "
          f"(seed {scenario.seed}) ==")
    if "wall_s" in verdict:
        note = "  ABORTED (max_wall_s)" if verdict["aborted"] else ""
        print(f"requests: {verdict['requests']}  "
              f"wall: {verdict['wall_s']:.3f}s  "
              f"engine restarts: {verdict['engine_restarts']}{note}")
    else:
        print(f"requests: {verdict['requests']}  (scored from log)")
    slo = verdict["slo"]
    if slo:
        print(f"slo verdict: {'PASS' if slo['ok'] else 'FAIL'}")
        for o in slo["objectives"]:
            cmp_ = "<=" if o["direction"] == "max" else ">="
            print(f"  {'ok ' if o['ok'] else 'VIOLATED':<9}"
                  f"{o['name']:<16} measured={_fmt(o['measured']):<12} "
                  f"{cmp_} {o['threshold']:.6g}")
    else:
        print("slo verdict: (no objectives declared)")
        for name, value in sorted(verdict["metrics"].items()):
            print(f"  {name:<16} {_fmt(value)}")
    if "baseline_written" in verdict:
        print(f"baseline updated: {args.baseline} "
              f"[{scenario.name}] <- "
              f"{len(verdict['baseline_written'])} metrics")
    elif args.check:
        if code == EXIT_NO_BASELINE:
            print(f"baseline: {args.baseline} has no entry for "
                  f"{scenario.name!r} — run with --update-baseline "
                  f"to set the bar (exit {EXIT_NO_BASELINE})")
        elif verdict["regressions"]:
            print(f"regressions (tolerance {tolerance:.0%}):")
            for line in verdict["regressions"]:
                print(f"  {line}")
        else:
            print(f"baseline: no regression (tolerance {tolerance:.0%})")
    if verdict.get("span_violations"):
        print(f"span conservation: "
              f"{len(verdict['span_violations'])} violation(s):")
        for line in verdict["span_violations"][:10]:
            print(f"  {line}")
    elif args.check and "span_violations" in verdict:
        print("span conservation: OK")
    print(f"exit: {code}")


if __name__ == "__main__":
    sys.exit(main())
