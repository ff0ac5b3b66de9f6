"""The port's ``observability`` against the JAX package's, on the CPU.

Held here:

- spans: ``emit_request_spans`` and ``emit_span`` write JAX's records and
  counters for the same inputs (the trio, chunk segments, a shed, a
  request that never left the queue);
- scoring: over the record stream of a port run with incidents (an engine
  restart, a poisoned slot, preemptions, deadline and queue sheds, a
  flight-recorder bundle), ``measure_slo_metrics`` (overall and by
  adapter), ``evaluate_slos``, ``check_span_conservation``,
  ``build_timelines``, ``format_timeline``, ``build_report``,
  ``render_report``, ``render_bundle`` and the gate's
  ``compare_to_baseline`` / ``update_baseline`` give JAX's results; the
  monitor CLI renders the log and a request's trace;
- sinks and the registry: the JSONL and Prometheus textfile outputs of
  the same registry calls equal JAX's;
- step metrics, span timers and profiler capture windows: JAX's records
  and events under an injected clock and stub capture hooks;
- the port's own: ``nvtx_range`` / ``annotate_fn`` timing into a
  registry, ``torch.profiler`` capture on the CPU, memory stats and the
  peak rate without a card, the deprecation warning once on rank 0.
"""

import copy
import os
import warnings

import pytest
import torch

from apex_tpu.loadtest import gate as jgate
from apex_tpu.observability import MetricsRegistry as JRegistry
from apex_tpu.observability import report as jreport
from apex_tpu.observability import sinks as jsinks
from apex_tpu.observability import slo as jslo
from apex_tpu.observability import step_metrics as jstep
from apex_tpu.observability import trace as jtrace
from apex_tpu.observability import tracing as jtracing
from apex_tpu.ops import _support as jax_support
from apex_tpu_torch import monitor
from apex_tpu_torch.loadtest import Scenario, build_model, gate, run_scenario
from apex_tpu_torch.observability import (InMemorySink, JsonlSink,
                                          MetricsRegistry,
                                          PrometheusTextfileSink, report,
                                          slo, step_metrics, trace, tracing)
from apex_tpu_torch.utils import deprecation, flops, profiling

#: one engine under strain: two slots, a short queue, deadlines shed by
#: the supervisor, batch traffic preempted by interactive, an injected
#: decode crash and a poisoned slot, and a flight recorder
INCIDENTS = {
    "name": "incidents", "seed": 5,
    "model": {"num_layers": 1, "hidden_size": 32, "num_attention_heads": 4,
              "vocab_size": 64, "max_position_embeddings": 64,
              "param_seed": 0},
    "engine": {"max_slots": 2, "max_len": 32, "max_queue": 6,
               "max_prefills_per_tick": 1, "page_size": 4,
               "prefill_token_budget": 8},
    "supervisor": {"shed_deadlines": True, "service_time_alpha": 0.3,
                   "max_restarts_per_request": 4},
    "faults": {"decode_raise_calls": [4], "poison_decode": {"9": [0, "nonfinite"]}},
    "recorder": {"events_capacity": 64, "records_capacity": 64,
                 "gauges_capacity": 16, "max_bundles": 1},
    "phases": [
        {"name": "batch", "priority": "batch", "n_requests": 6,
         "rate_rps": 400.0, "prompt_lens": {"12": 1, "4": 1},
         "max_new_tokens": {"10": 1}, "greedy_fraction": 0.5,
         "temperatures": [0.8], "top_ks": [0, 8]},
        {"name": "interactive", "priority": "interactive",
         "n_requests": 8, "rate_rps": 800.0, "prompt_lens": {"4": 1, "6": 1},
         "max_new_tokens": {"3": 1, "5": 1}, "deadline_fraction": 0.5,
         "deadline_min_s": 0.001, "deadline_max_s": 0.002}],
    "slo": {"ttft_p99_s": 60.0, "tpot_p99_s": 10.0, "latency_p99_s": 120.0,
            "goodput": 0.5, "goodput_interactive": 0.1,
            "error_budget": 0.5, "recovery_s": 60.0},
    "tolerance": 0.5, "max_wall_s": 120.0,
}


@pytest.fixture(autouse=True)
def _jax_plain_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_FORCE_PALLAS", "off")
    jax_support.pallas_mode.cache_clear()
    yield
    jax_support.pallas_mode.cache_clear()


@pytest.fixture(scope="module")
def incident_run(tmp_path_factory):
    log = str(tmp_path_factory.mktemp("incidents") / "run.jsonl")
    scenario = Scenario.from_dict(copy.deepcopy(INCIDENTS))
    model = build_model(scenario.model, device="cpu")
    run = run_scenario(scenario, model=model, log_path=log)
    return run, log


def _registries():
    psink, jsink = InMemorySink(), jsinks.InMemorySink()
    return (MetricsRegistry(sinks=[psink]), psink,
            JRegistry(sinks=[jsink]), jsink)


SPAN_CASES = {
    "trio": dict(prefill_start=11.0, prefill_end=11.5),
    "chunked": dict(prefill_start=11.0, prefill_end=12.0,
                    prefill_segments=(11.25, 11.5, 11.75)),
    "shed": dict(detail="queue_full"),
    "never_prefilled": dict(),
    "replica": dict(prefill_start=10.5, prefill_end=10.75, replica_id=3),
}


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_emit_request_spans_writes_jax_records(case):
    reg, sink, jreg, jsink = _registries()
    kw = dict(trace_id="00ff00ff00ff00ff", request_id=17, submit_ts=10.0,
              now=13.0, wall=1.7e9, **SPAN_CASES[case])
    got = trace.emit_request_spans(reg, **kw)
    want = jtrace.emit_request_spans(jreg, **kw)
    assert got == want and sink.records == jsink.records
    trace.emit_span(reg, trace.SPAN_PREEMPT, trace_id="ab", request_id=1,
                    start_s=1.0, end_s=1.0, wall=2.0, detail="priority",
                    tokens_parked=3)
    jtrace.emit_span(jreg, jtrace.SPAN_PREEMPT, trace_id="ab", request_id=1,
                     start_s=1.0, end_s=1.0, wall=2.0, detail="priority",
                     tokens_parked=3)
    assert reg.counters() == jreg.counters()
    assert (trace.PHASE_SPANS, trace.MARK_SPANS) == \
        (jtrace.PHASE_SPANS, jtrace.MARK_SPANS)


def test_incident_run_is_conserved_and_terminal(incident_run):
    run, _ = incident_run
    assert not run.aborted and run.retraces == 0
    assert len(run.results) == run.submitted == 14
    counters = run.counters
    assert counters["engine_restarts"] >= 1
    assert counters["slots_quarantined"] >= 1
    assert counters["requests_submitted"] == sum(
        counters[f"requests_{r}"] for r in ("length", "eos", "error",
                                            "rejected", "timeout",
                                            "cancelled"))
    assert trace.check_span_conservation(run.records) == []
    assert run.bundles and os.path.exists(run.bundle_paths[0])


def test_slo_scoring_matches_jax(incident_run):
    run, _ = incident_run
    recs = run.records
    assert slo.measure_slo_metrics(recs) == jslo.measure_slo_metrics(recs)
    assert slo.measure_slo_metrics(recs, by_adapter=True) == \
        jslo.measure_slo_metrics(recs, by_adapter=True)
    spec = INCIDENTS["slo"]
    got = slo.evaluate_slos(recs, slo.SLOSpec.from_dict(spec))
    want = jslo.evaluate_slos(recs, jslo.SLOSpec.from_dict(spec))
    assert got.as_dict() == want.as_dict()
    assert got.as_dict() == run.slo.as_dict()
    assert slo.SLO_METRICS == jslo.SLO_METRICS


def test_traces_and_report_match_jax(incident_run, tmp_path):
    run, log = incident_run
    recs = run.records
    assert trace.check_span_conservation(recs) == \
        jtrace.check_span_conservation(recs)
    # a forged duplicate span row breaks conservation the same way
    forged = recs + [dict(next(r for r in recs if r.get("kind") == "span"
                               and r["span"] == "decode"))]
    assert trace.check_span_conservation(forged) == \
        jtrace.check_span_conservation(forged) != []
    lines = trace.build_timelines(recs)
    assert lines == jtrace.build_timelines(recs)
    results = {r["request_id"]: r for r in recs if r.get("kind") == "request"}
    for rid, spans in lines.items():
        assert trace.format_timeline(rid, spans, results.get(rid)) == \
            jtrace.format_timeline(rid, spans, results.get(rid))
    assert report.read_records(log) == jreport.read_records(log)
    got = report.build_report(log, slo_spec=INCIDENTS["slo"])
    want = jreport.build_report(log, slo_spec=INCIDENTS["slo"])
    assert got == want
    assert report.render_report(got) == jreport.render_report(want) \
        .replace("== apex_tpu run report", "== apex_tpu_torch run report")
    bundle = run.bundles[0]
    assert report.render_bundle(bundle) == jreport.render_bundle(bundle) \
        .replace("== apex_tpu postmortem", "== apex_tpu_torch postmortem")


def test_gate_matches_jax(incident_run, tmp_path):
    run, _ = incident_run
    metrics = dict(run.metrics_by_name)
    p, j = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert gate.update_baseline(p, "incidents", metrics) == \
        jgate.update_baseline(j, "incidents", metrics)
    with open(p) as a, open(j) as b:
        assert a.read() == b.read()
    assert gate.load_baseline(p) == jgate.load_baseline(j)
    worse = {k: (None if v is None else v * 3.0) for k, v in metrics.items()}
    worse["goodput"] = 0.0
    entry = gate.load_baseline(p)["incidents"]
    for tol in (0.0, 0.5):
        got = [r.describe() for r in gate.compare_to_baseline(worse, entry,
                                                              tol)]
        want = [r.describe() for r in jgate.compare_to_baseline(
            worse, entry, tol)]
        assert got == want != []
    assert gate.compare_to_baseline(metrics, entry, 0.0) == []
    assert gate.DEFAULT_BASELINE == "SLO_BASELINE_TORCH.json"


def test_monitor_cli_renders_log_and_trace(incident_run, capsys):
    run, log = incident_run
    assert monitor.main([log]) == 0
    out = capsys.readouterr().out
    assert "span conservation: OK" in out
    rid = next(r["request_id"] for r in run.records
               if r.get("kind") == "request"
               and r.get("finish_reason") == "length")
    assert monitor.main([log, "--trace", str(rid)]) == 0
    assert "span sum:" in capsys.readouterr().out


def _drive(reg):
    reg.declare_counters("requests_length")
    reg.inc("requests_length", 3)
    reg.inc("spans_decode")
    reg.set_gauge("kv_pages_free", 12)
    reg.set_gauge("memory/device0/bytes_in_use", 1024)
    for v in (0.1, 0.4, 0.2, 0.3):
        reg.observe("request_ttft_s", v)
    reg.event("engine_restart", failure="decode", wall=5.0, ts=1.0)
    reg.emit_record({"kind": "request", "request_id": 1, "wall": 3.0})
    reg.flush()
    reg.close()


def test_sinks_write_jax_files(tmp_path, monkeypatch):
    monkeypatch.setattr("time.time", lambda: 1.7e9)
    monkeypatch.setattr("time.monotonic", lambda: 50.0)
    outs = []
    for jsonl, prom, reg_cls, sub in (
            (jsinks.JsonlSink, jsinks.PrometheusTextfileSink, JRegistry,
             "jax"),
            (JsonlSink, PrometheusTextfileSink, MetricsRegistry, "port")):
        d = tmp_path / sub
        d.mkdir()
        reg = reg_cls(sinks=[jsonl(str(d / "run.jsonl"))])
        reg.add_sink(prom(str(d / "m.prom")))
        _drive(reg)
        assert set(reg.histograms()) == {"request_ttft_s"}
        outs.append(((d / "run.jsonl").read_text(),
                     (d / "m.prom").read_text()))
    assert outs[0] == outs[1]


def test_step_metrics_match_jax():
    clock = iter([float(t) for t in range(100)])
    jclock = iter([float(t) for t in range(100)])
    reg, sink, jreg, jsink = _registries()
    sm = step_metrics.StepMetrics(reg, tokens_per_step=4096,
                                  model_flops_per_step=3e12,
                                  peak_flops=989e12,
                                  memory_interval_steps=2,
                                  clock=lambda: next(clock))
    jsm = jstep.StepMetrics(jreg, tokens_per_step=4096,
                            model_flops_per_step=3e12, peak_flops=989e12,
                            memory_interval_steps=2,
                            clock=lambda: next(jclock))
    for step in (1, 2, 3):
        for m in (sm, jsm):
            m.begin_step()
            m.end_step(step)
        assert sm.record_polled(step, loss=2.0 / step, grad_norm=1.5,
                                skipped=step == 2, loss_scale=65536.0) == \
            jsm.record_polled(step, loss=2.0 / step, grad_norm=1.5,
                              skipped=step == 2, loss_scale=65536.0)
    with step_metrics.StepTimer(reg, "data_wait_s", clock=lambda: 7.0):
        pass
    with jstep.StepTimer(jreg, "data_wait_s", clock=lambda: 7.0):
        pass
    assert sink.records == jsink.records
    assert reg.counters() == jreg.counters()
    assert reg.gauges() == jreg.gauges()
    assert {k: (v.count, v.sum) for k, v in reg.histograms().items()} == \
        {k: (v.count, v.sum) for k, v in jreg.histograms().items()}


def test_profiler_capture_windows_match_jax(tmp_path):
    calls, jcalls = [], []
    reg, sink, jreg, jsink = _registries()
    cap = tracing.ProfilerCapture(
        str(tmp_path), every_n_steps=3, capture_steps=2, max_captures=2,
        registry=reg, start_fn=lambda d: calls.append(("start", d)),
        stop_fn=lambda: calls.append(("stop",)))
    jcap = jtracing.ProfilerCapture(
        str(tmp_path), every_n_steps=3, capture_steps=2, max_captures=2,
        registry=jreg, start_fn=lambda d: jcalls.append(("start", d)),
        stop_fn=lambda: jcalls.append(("stop",)))
    for step in range(1, 12):
        for c in (cap, jcap):
            c.on_step(step)
            if step == 4:
                c.on_incident("watchdog", step)
    assert calls == jcalls and cap.captures == jcap.captures == 2
    drop = ("seq", "ts", "wall")
    assert [{k: v for k, v in r.items() if k not in drop}
            for r in sink.records] == \
        [{k: v for k, v in r.items() if k not in drop}
         for r in jsink.records]
    with tracing.span("fwd", reg):
        pass
    assert reg.histogram("span/fwd_s").count == 1


def test_profiling_helpers_on_the_cpu(tmp_path):
    reg = MetricsRegistry()
    with profiling.nvtx_range("block", registry=reg):
        torch.ones(4).sum()

    @profiling.annotate_fn(registry=reg)
    def step():
        return torch.ones(2) * 2

    step()
    step()
    assert reg.histogram("span/block_s").count == 1
    assert reg.histogram("span/step_s").count == 2
    with profiling.trace(str(tmp_path)):
        torch.ones(8).sum()
    assert os.listdir(tmp_path)
    with pytest.raises(RuntimeError, match="no profiler capture"):
        profiling.profiler_stop()
    assert profiling.device_memory_stats("cpu") == {}
    assert flops.peak_flops_per_chip("cpu") is None
    assert flops.transformer_train_flops(1000, 8, 2, 16, 4, True) == \
        8 * (6.0 * 1000 + 12 * 2 * 4 * 16 * 0.5)


def test_probes_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.device_memory_stats()
    assert flops.peak_flops_per_chip() is None


def test_deprecated_warning_once_on_rank_zero():
    msg = "apex_tpu_torch test deprecation, issued once"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        deprecation.deprecated_warning(msg)
        deprecation.deprecated_warning(msg)
    hits = [w for w in caught if str(w.message) == msg]
    assert len(hits) == 1
    assert issubclass(hits[0].category, deprecation.DeprecatedFeatureWarning)
