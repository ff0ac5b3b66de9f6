"""Metric sinks: where :class:`~apex_tpu_torch.observability.registry.
MetricsRegistry` records land.

A sink is any object with ``write(record: dict)``, ``flush()`` and
``close()``; the registry serializes all calls under its own lock, so
sinks need not be thread-safe. Three implementations:

- :class:`InMemorySink` — keeps records in a list; for tests and
  notebook inspection.
- :class:`JsonlSink` — one JSON object per line; the durable run log the
  ``python -m apex_tpu_torch.monitor`` CLI reads back into a run report.
- :class:`PrometheusTextfileSink` — renders the latest counter/gauge/
  histogram snapshots in Prometheus text exposition format on ``flush``,
  atomically (write temp + rename), for the node-exporter textfile
  collector to scrape.

Copied from ``apex_tpu/observability/sinks.py`` (stdlib only), so the port never imports
the JAX package.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional

__all__ = ["InMemorySink", "JsonlSink", "PrometheusTextfileSink"]


class InMemorySink:
    """Record list in memory — the test double."""

    def __init__(self):
        self.records: List[dict] = []
        self.closed = False

    def write(self, record: dict) -> None:
        self.records.append(record)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.closed = True

    def of_kind(self, kind: str) -> List[dict]:
        return [r for r in self.records if r.get("kind") == kind]


class JsonlSink:
    """Append records as JSON lines to ``path`` (parent dirs created).

    Non-JSON-serializable field values degrade to ``str(value)`` rather
    than killing the training loop — a telemetry write must never be the
    thing that takes a run down.
    """

    def __init__(self, path: str):
        self.path = os.fspath(path)
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._file = open(self.path, "a", encoding="utf-8")

    def write(self, record: dict) -> None:
        try:
            line = json.dumps(record)
        except (TypeError, ValueError):
            line = json.dumps({k: _jsonable(v) for k, v in record.items()})
        self._file.write(line + "\n")

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.flush()
            self._file.close()


def _jsonable(value):
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return str(value)


# Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*
_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _split_labels(name: str) -> tuple:
    """Split ``kv_pages_free{replica="1"}`` into the bare metric name
    and its ``{...}`` label block (empty string when unlabeled) — the
    registry stores labeled gauges as flat keys in this form."""
    brace = name.find("{")
    if brace == -1 or not name.endswith("}"):
        return name, ""
    return name[:brace], name[brace:]


def _prom_name(name: str, suffix: str = "") -> str:
    base, labels = _split_labels(name)
    base = _PROM_BAD.sub("_", base)
    if not re.match(r"[a-zA-Z_:]", base):
        base = "_" + base
    # the JAX package's metric prefix, kept so one dashboard reads both
    return f"apex_tpu_{base}{suffix}{labels}"


class PrometheusTextfileSink:
    """Textfile-collector exporter: keeps the most recent snapshot records
    and renders them to ``path`` on ``flush``. Counters render with a
    ``_total`` suffix, histograms as ``_count``/``_sum`` plus ``p50``/
    ``p95`` quantile gauges. Per-record writes other than snapshots are
    ignored — Prometheus scrapes state, not a stream."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        self._counters: Optional[dict] = None
        self._gauges: Optional[dict] = None
        self._histograms: Optional[dict] = None

    def write(self, record: dict) -> None:
        kind = record.get("kind")
        if kind == "counters":
            self._counters = record.get("values", {})
        elif kind == "gauges":
            self._gauges = record.get("values", {})
        elif kind == "histograms":
            self._histograms = record.get("values", {})

    def flush(self) -> None:
        lines: List[str] = []
        typed: set = set()  # one TYPE line per metric family, not per label set
        for name, value in sorted((self._counters or {}).items()):
            metric = _prom_name(name, "_total")
            family = _prom_name(_split_labels(name)[0], "_total")
            if family not in typed:
                typed.add(family)
                lines.append(f"# TYPE {family} counter")
            lines.append(f"{metric} {value}")
        for name, value in sorted((self._gauges or {}).items()):
            metric = _prom_name(name)
            family = _prom_name(_split_labels(name)[0])
            if family not in typed:
                typed.add(family)
                lines.append(f"# TYPE {family} gauge")
            lines.append(f"{metric} {value}")
        for name, summ in sorted((self._histograms or {}).items()):
            base, labels = _split_labels(name)
            family = _prom_name(base)
            if family not in typed:
                typed.add(family)
                lines.append(f"# TYPE {family} summary")
            lines.append(f"{family}_count{labels} {summ.get('count', 0)}")
            lines.append(f"{family}_sum{labels} {summ.get('sum', 0.0)}")
            for q in ("p50", "p95"):
                if q in summ:
                    # fold quantile into the existing label block: a
                    # labeled series must stay one series per label set
                    quantile = f'quantile="0.{q[1:]}"'
                    block = (f"{labels[:-1]},{quantile}}}" if labels
                             else f"{{{quantile}}}")
                    lines.append(f"{family}{block} {summ[q]}")
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        os.replace(tmp, self.path)  # atomic: scrapers never see a torn file

    def close(self) -> None:
        self.flush()
