"""Host-side telemetry export: serve-loop spans and captured series out to
Chrome trace-event JSON (Perfetto-loadable) and a text summary.

PyTorch counterpart of ``repro.runtime.obs``; the instruments themselves
are ``repro_torch.core.telemetry``.

- `SpanRecorder`: wall-clock "X" (complete) events around host loop
  phases. A span synchronizes the device of the tensors handed to it in
  `sync` before it closes, so its duration covers the device work the
  phase queued; nothing is read back to the host.
- `counter_events` / `trace_export`: spans plus one "C" counter track per
  series channel in one ``{"traceEvents": [...]}`` document, with the
  reference's event schema; counters sit on a synthetic
  steps-as-microseconds timebase.
- `summary`: percentiles and the last series row as text.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from repro_torch.core.compute_plane import tree_leaves, tree_map
from repro_torch.core.telemetry import (TelemetryConfig, TelemetryState,
                                        percentiles_from_state, series_rows)


def _synchronize(tree):
    """Wait for the queued work of every CUDA device holding a tensor of
    `tree`; CPU tensors need no wait."""
    devices = {t.device for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class SpanRecorder:
    """Collects Chrome trace "X" (complete) events on a host wall clock
    relative to construction time. `span(...)` yields a dict; a tree of
    tensors stored under "sync" is waited for before the span closes."""

    def __init__(self, pid: int = 0):
        self.pid = pid
        self.events: list = []
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, tid: int = 0, **args):
        t_start = self._now_us()
        sync = {}
        try:
            yield sync
        finally:
            if sync.get("sync") is not None:
                _synchronize(sync["sync"])
            self.events.append({
                "name": name, "ph": "X", "ts": t_start,
                "dur": self._now_us() - t_start,
                "pid": self.pid, "tid": tid,
                "args": {k: _jsonable(v) for k, v in args.items()},
            })

    def instant(self, name: str, tid: int = 0, **args):
        self.events.append({
            "name": name, "ph": "i", "ts": self._now_us(), "s": "t",
            "pid": self.pid, "tid": tid,
            "args": {k: _jsonable(v) for k, v in args.items()},
        })


def _jsonable(v):
    if isinstance(v, torch.Tensor):
        return v.tolist()
    if isinstance(v, (np.generic, np.ndarray)):
        return v.tolist()
    return v


def counter_events(tel: TelemetryState, cfg: TelemetryConfig, labels,
                   *, pid: int = 0, name_prefix: str = "",
                   step_us: float = 1000.0, t0_us: float = 0.0) -> list:
    """One series ring -> one Chrome "C" counter track per channel label,
    `step_us` microseconds per decode step from `t0_us`."""
    steps, rows = series_rows(tel, cfg)
    if rows.shape[1] != len(labels):
        raise ValueError(f"series has {rows.shape[1]} channels but "
                         f"{len(labels)} labels given")
    events = []
    for j, label in enumerate(labels):
        name = f"{name_prefix}{label}"
        for s, row in zip(steps, rows):
            events.append({"name": name, "ph": "C",
                           "ts": t0_us + float(s) * step_us,
                           "pid": pid,
                           "args": {label: float(row[j])}})
    return events


def trace_export(path: Optional[str] = None, *, spans=None,
                 counters=None, metadata=None) -> dict:
    """Spans (`SpanRecorder.events`) + counter events (`counter_events`)
    as one Chrome trace-event JSON document, written to `path` when
    given. Returns the document dict."""
    events = []
    for name, pid in (metadata or {}).items():
        events.append({"name": "process_name", "ph": "M", "ts": 0.0,
                       "pid": pid, "tid": 0, "args": {"name": name}})
    events.extend(spans or [])
    events.extend(counters or [])
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc


def summary(title: str, tel: TelemetryState, cfg: TelemetryConfig,
            labels, *, unit: str = "steps",
            warm: Optional[TelemetryState] = None) -> str:
    """Text block: tail percentiles (warm-delta when a warm snapshot is
    given) and the last sampled series row (of tenant 0 for a batched
    state)."""
    lines = [f"# telemetry: {title} (level={cfg.level})"]
    if cfg.histogram_on:
        p50, p95, p99 = percentiles_from_state(tel, [0.5, 0.95, 0.99],
                                               base=warm)
        lines.append(f"  latency {unit}: p50={p50:.3g} p95={p95:.3g} "
                     f"p99={p99:.3g}")
    if cfg.series_on:
        t0 = tree_map(lambda x: x[0], tel) if tel.series.ndim == 3 else tel
        steps, rows = series_rows(t0, cfg)
        if len(steps):
            last = rows[-1]
            pairs = " ".join(f"{k}={v:.4g}" for k, v in zip(labels, last))
            lines.append(f"  series[{len(steps)} samples, last @step "
                         f"{int(steps[-1])}]: {pairs}")
    return "\n".join(lines)
