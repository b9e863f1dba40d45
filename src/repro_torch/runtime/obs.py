"""Host-side telemetry export: serve-loop spans and captured series out to
Chrome trace-event JSON (Perfetto-loadable) and a text summary.

PyTorch counterpart of ``repro.runtime.obs``; the instruments themselves
are ``repro_torch.core.telemetry``.

- `SpanRecorder`: "X" (complete) events. `span(...)` is the serve loops'
  phase span (`prefill`, `decode`, `decode_step`): it synchronizes the
  device of the tensors handed to it in `sync` before it closes, so its
  duration covers the device work the phase queued; nothing is read
  back to the host.
- `counter_events` / `trace_export`: spans plus one "C" counter track per
  series channel in one ``{"traceEvents": [...]}`` document, with the
  reference's event schema; counters sit on a synthetic
  steps-as-microseconds timebase from `t0_us`.
- `summary`: percentiles and the last series row as text.

Turning the layer spans on: ``with rec.active(): serve_batch_paged(...)``
makes `rec` the recorder of ``core.telemetry.span`` for the block. The
port then records, with `args` holding the span's `id`, its enclosing
span's id as `parent`, the id of the `serve.call` it sits under as
`call`, and the counts of its boundary:

- `serve.call`: one call of `serve_batch`, `serve_batch_paged` or
  `serve_replicated` (entry, batch, prompt, new_tokens);
- `serve.step`: each token step of those loops (phase, step, tokens);
- `model.decode`: `models.model.decode_step` (batch);
- `model.moe`: each MoE layer's call, `models.moe.moe` (tokens,
  experts, k; `routed`, the distinct experts the tokens were routed
  to, counted from the routing when the events are read);
- `store.step`: the store's step, `daemon_store._step` (requests), and
  inside it its parts `store.residency` (the residency transaction),
  `store.remote_fetch`, `store.writebacks`, `store.schedule` and
  `store.fold` (the stats fold and the telemetry record).

Off (no recorder active, no profiler running) each is one shared no-op
context. A layer span never synchronizes: its duration is host time,
from entering the layer to handing back its queued work; the device
time of a layer is what a `torch.profiler` trace attributes to it (under
a running profiler every span is also a `record_function` range of its
name, so a kernel's launch call falls inside it). The recorder keeps one
stack of open spans, so it records one thread's loops.

Clock: every event, the phase spans' too, is stamped in microseconds of
Unix-epoch time (`time.time_ns`), the base of the `start_ns()` that
`torch.profiler`'s kineto events carry, so a span lines up with the
device trace and with the profiler's own Chrome export.
"""
from __future__ import annotations

import itertools
import json
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from repro_torch.core import telemetry
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
    """Collects Chrome trace "X" (complete) events stamped in Unix-epoch
    microseconds. `span(...)` yields a dict; a tree of tensors stored
    under "sync" is waited for before the span closes. `active()` makes
    the recorder the target of ``core.telemetry.span`` for a block."""

    def __init__(self, pid: int = 0):
        self.pid = pid
        self._events: list = []
        self._deferred: list = []      # events with counts still to read
        self._open: list = []          # (id, call, name, counts) open
        self._ids = itertools.count(1)

    @property
    def events(self) -> list:
        """The events, each deferred count (``core.telemetry.note``) read
        now, once."""
        for event in self._deferred:
            args = event["args"]
            for key, value in args.items():
                if callable(value):
                    args[key] = _jsonable(value())
        self._deferred.clear()
        return self._events

    def _event(self, name, t_start_ns, tid, args) -> dict:
        return {"name": name, "ph": "X", "ts": t_start_ns / 1e3,
                "dur": (time.time_ns() - t_start_ns) / 1e3,
                "pid": self.pid, "tid": tid,
                "args": {k: _jsonable(v) for k, v in args.items()}}

    @contextmanager
    def span(self, name: str, tid: int = 0, **args):
        t_start = time.time_ns()
        sync = {}
        try:
            yield sync
        finally:
            if sync.get("sync") is not None:
                _synchronize(sync["sync"])
            self._events.append(self._event(name, t_start, tid, args))

    def active(self):
        """Context: this recorder takes ``core.telemetry.span``'s layer
        spans for the block."""
        return telemetry.recording(self)

    def open_span(self, name: str, counts: dict):
        """Enter a layer span (``core.telemetry.span``); returns the
        token `close_span` takes."""
        sid = next(self._ids)
        parent, call = self._open[-1][:2] if self._open else (None, None)
        if name == telemetry.CALL_SPAN:
            call = sid
        counts = dict(counts)
        self._open.append((sid, call, name, counts))
        return name, counts, sid, parent, call, time.time_ns()

    def note_span(self, name: str, counts: dict):
        """Add `counts` to the innermost open layer span if it is `name`
        (``core.telemetry.note``)."""
        if self._open and self._open[-1][2] == name:
            self._open[-1][3].update(counts)

    def close_span(self, token):
        name, counts, sid, parent, call, t_start = token
        self._open.pop()
        event = self._event(name, t_start, 0, {"id": sid, "parent": parent,
                                               "call": call, **counts})
        if any(callable(v) for v in counts.values()):
            self._deferred.append(event)
        self._events.append(event)


def _jsonable(v):
    if callable(v):
        return v                       # a deferred count, read later
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
