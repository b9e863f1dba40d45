"""Telemetry plane: a latency histogram and a per-step series ring carried
as tensors beside the state they observe.

PyTorch counterpart of ``repro.core.telemetry``:

- a fixed-bin log-spaced latency histogram (`record_latency`), from
  which percentiles are read by a CDF walk over the bins
  (`percentiles_from_state`, `approx_percentiles`): the geometric
  midpoint of the bin holding the smallest sample whose CDF reaches q;
- a fixed-capacity series ring (`record_series`): one (C,) row every
  `series_every` steps, oldest overwritten first; `series_rows` unwraps
  it on the host in time order for the exporter (``runtime.obs``).

The static `TelemetryConfig.level` (off < counters < histogram < trace)
decides which instruments exist. `off` makes `init_state` return None:
the store then carries no instrument state and does no telemetry work.
`counters` turns on the series ring, `histogram` adds the histogram,
`trace` asks host loops to record spans as well.

Every instrument takes an optional leading batch axis (the store keeps
one histogram and one ring per tenant). The bin index stays in f32, as
the reference computes it; the reference's dropping scatters become
masked adds.

`span(name, **counts)` marks a layer boundary of the host loops (the
serve loops, the model's decode and its MoE layers, the store's step and
its parts; the names are in ``runtime.obs``), and `note(name, **counts)`
adds counts that the layer learns inside it. It is off by default: with
no recorder active (`recording`, which ``runtime.obs.SpanRecorder.active``
enters) and no `torch.profiler` running it returns one shared no-op
context. Otherwise it records on the active recorder and, under a profiler,
opens a `record_function` range of the same name. A span never
synchronises the device and never reads a device value.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler

F32 = torch.float32

# the level lattice, in order: each level includes everything below it
LEVELS = ("off", "counters", "histogram", "trace")


@dataclass(frozen=True)
class TelemetryConfig:
    """STATIC observability axis. `lat_lo`/`lat_hi` bound the histogram's
    log-spaced bin range in the caller's latency unit (decode steps on
    the store); values below `lat_lo` clamp into bin 0, above `lat_hi`
    into the last bin."""
    level: str = "off"
    bins: int = 64                # histogram bins (log-spaced)
    lat_lo: float = 1.0           # lower edge of bin 0 (> 0)
    lat_hi: float = 1e8           # upper edge of the last bin
    series_cap: int = 128         # ring capacity (rows kept)
    series_every: int = 1         # sample every k steps

    def __post_init__(self):
        if self.level not in LEVELS:
            raise ValueError(f"level must be one of {LEVELS}, "
                             f"got {self.level!r}")
        if self.bins < 2:
            raise ValueError(f"bins must be >= 2, got {self.bins}")
        if not (0.0 < self.lat_lo < self.lat_hi):
            raise ValueError(f"need 0 < lat_lo < lat_hi, got "
                             f"({self.lat_lo}, {self.lat_hi})")
        if self.series_cap < 1 or self.series_every < 1:
            raise ValueError("series_cap and series_every must be >= 1")

    @property
    def enabled(self) -> bool:
        return self.level != "off"

    @property
    def series_on(self) -> bool:
        return self.level in ("counters", "histogram", "trace")

    @property
    def histogram_on(self) -> bool:
        return self.level in ("histogram", "trace")

    @property
    def trace_on(self) -> bool:
        return self.level == "trace"


class TelemetryState(NamedTuple):
    """Instrument state; in a batched store every leaf has a leading
    (B,) axis."""
    hist: torch.Tensor       # (BINS,) f32 latency counts
    edges: torch.Tensor      # (BINS+1,) f32 log-spaced bin edges
    series: torch.Tensor     # (CAP, C) f32 ring of sampled rows
    series_n: torch.Tensor   # () f32 samples taken (ring write cursor)


def bin_edges(cfg: TelemetryConfig) -> np.ndarray:
    """(BINS+1,) log-spaced edges over [lat_lo, lat_hi] (host-side)."""
    return np.logspace(np.log10(cfg.lat_lo), np.log10(cfg.lat_hi),
                       cfg.bins + 1).astype(np.float32)


def init_state(cfg: Optional[TelemetryConfig], channels: int,
               device=None) -> Optional[TelemetryState]:
    """Fresh instrument state, or None when telemetry is off."""
    if cfg is None or not cfg.enabled:
        return None
    return TelemetryState(
        hist=torch.zeros((cfg.bins,), dtype=F32, device=device),
        edges=torch.from_numpy(bin_edges(cfg)).to(device),
        series=torch.zeros((cfg.series_cap, channels), dtype=F32,
                           device=device),
        series_n=torch.zeros((), dtype=F32, device=device))


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """`x` as a 0-d f32 tensor, filled on `like`'s device (no copy from
    the host, so no synchronization)."""
    return torch.full((), x, dtype=F32, device=like.device)


def record_latency(tel: Optional[TelemetryState], cfg: TelemetryConfig,
                   value, gate=True) -> Optional[TelemetryState]:
    """Add `value` (the caller's latency unit; (N,) per histogram, or
    (B, N) for a batched state) to the log-spaced histogram; samples
    where `gate` is False are not counted. No-op below the histogram
    level. The bin is floor(log(v / lat_lo) / span * bins) in f32,
    clamped to the bins; divisions are by f32 tensors, so the same on
    every device."""
    if tel is None or not cfg.histogram_on:
        return tel
    hist = tel.hist
    v = torch.as_tensor(value, device=hist.device).to(F32)
    v = v.reshape(hist.shape[:-1] + (-1,))
    g = torch.as_tensor(gate, device=hist.device).to(torch.bool)
    g = g.expand(v.shape)
    span = float(np.float32(np.log(cfg.lat_hi / cfg.lat_lo)))
    ratio = torch.clamp(v, min=1e-30) / _f32(cfg.lat_lo, v)
    idx = torch.floor(torch.log(ratio) / _f32(span, v)
                      * _f32(cfg.bins, v)).to(torch.int32)
    idx = torch.clamp(idx, 0, cfg.bins - 1).long()
    hist = hist.scatter_add(-1, idx, g.to(F32))
    return tel._replace(hist=hist)


def record_series(tel: Optional[TelemetryState], cfg: TelemetryConfig,
                  step, values) -> Optional[TelemetryState]:
    """Write one (C,) row ((B, C) for a batched state) into the ring when
    `step` (0-based, int or 0-d tensor) is on the `series_every` grid;
    an off-grid step writes nothing. The ring index wraps, so a long run
    keeps the last `series_cap` samples. No-op below the counters
    level."""
    if tel is None or not cfg.series_on:
        return tel
    series = tel.series
    step = torch.as_tensor(step, device=series.device).to(torch.int32)
    on_grid = (step % cfg.series_every) == 0
    row = torch.div(step, cfg.series_every, rounding_mode="floor") \
        % cfg.series_cap
    cap = series.shape[-2]
    hit = on_grid & (torch.arange(cap, device=series.device) == row)
    values = torch.as_tensor(values, device=series.device).to(F32)
    series = torch.where(hit[:, None], values.unsqueeze(-2), series)
    return tel._replace(series=series,
                        series_n=tel.series_n + on_grid.to(F32))


def merge(a: Optional[TelemetryState],
          b: Optional[TelemetryState]) -> Optional[TelemetryState]:
    """Histogram-sum two states (batch fold); series keeps `a`'s ring."""
    if a is None or b is None:
        return a if b is None else b
    return a._replace(hist=a.hist + b.hist)


# --------------------------------------------------------------- readers
def approx_percentiles(hist, edges, qs) -> torch.Tensor:
    """For each q in `qs` (fractions in (0, 1]), the geometric midpoint
    of the bin holding the smallest sample whose CDF reaches q; 0 for an
    empty histogram. Tensor in, tensor out (no host read)."""
    hist = torch.as_tensor(hist).to(F32)
    edges = torch.as_tensor(edges, device=hist.device).to(F32)
    mids = torch.sqrt(edges[:-1] * edges[1:])
    total = hist.sum()
    cum = torch.cumsum(hist, dim=0)
    q = torch.as_tensor(qs, dtype=F32, device=hist.device).reshape(-1)
    idx = (cum[None, :] >= q[:, None] * total).to(torch.int32).argmax(dim=1)
    return torch.where(total > 0, mids[idx],
                       torch.zeros((), dtype=F32, device=hist.device))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def percentiles_from_state(tel: TelemetryState, qs,
                           base: Optional[TelemetryState] = None) -> list:
    """Host-side percentile read from a (possibly batched) state: a
    leading batch axis on `hist` is summed; `base` (a warm-boundary
    snapshot) is subtracted first."""
    hist = _host(tel.hist).astype(np.float64)
    if base is not None:
        hist = hist - _host(base.hist).astype(np.float64)
    hist = hist.reshape(-1, hist.shape[-1]).sum(axis=0)
    edges = _host(tel.edges).astype(np.float64).reshape(-1)[
        : hist.shape[0] + 1]
    mids = np.sqrt(edges[:-1] * edges[1:])
    total = hist.sum()
    if total <= 0:
        return [0.0 for _ in np.atleast_1d(qs)]
    cum = np.cumsum(hist)
    return [float(mids[int(np.argmax(cum >= q * total))])
            for q in np.atleast_1d(qs)]


def series_rows(tel: TelemetryState, cfg: TelemetryConfig):
    """Unwrap one ring into time order (host-side). Returns (steps (n,)
    int64, rows (n, C) float32), oldest first."""
    series = _host(tel.series)
    n = int(_host(tel.series_n))
    cap = series.shape[0]
    if n <= cap:
        rows = series[:n]
        first = 0
    else:
        cut = n % cap
        rows = np.concatenate([series[cut:], series[:cut]], axis=0)
        first = n - cap
    steps = (first + np.arange(rows.shape[0], dtype=np.int64)) \
        * cfg.series_every
    return steps, rows.astype(np.float32)


# ----------------------------------------------------------------- spans
CALL_SPAN = "serve.call"   # the span whose id is its spans' `call`
_recorder = None           # the recorder `span` records on, or None
_NO_SPAN = nullcontext()


@contextmanager
def recording(recorder):
    """Make `recorder` (a ``runtime.obs.SpanRecorder``) the one `span`
    records on, process-wide, for the block; the one active before comes
    back after it."""
    global _recorder
    before, _recorder = _recorder, recorder
    try:
        yield recorder
    finally:
        _recorder = before


class _Span:
    """One open span: an event of the active recorder and, under a
    profiler, a `record_function` range inside it."""
    __slots__ = ("rec", "name", "args", "token", "range")

    def __init__(self, rec, name: str, args: dict):
        self.rec, self.name, self.args = rec, name, args
        self.token = self.range = None

    def __enter__(self):
        if self.rec is not None:
            self.token = self.rec.open_span(self.name, self.args)
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.rec is not None:
            self.rec.close_span(self.token)
        return False


def span(name: str, **args):
    """A context around one layer's work at its boundary; `args` are the
    counts recorded there (host ints, never device values)."""
    rec = _recorder
    if rec is None and not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(rec, name, args)


def note(name: str, **args):
    """Add `args` to the innermost open span of the active recorder if
    that span is `name`; nothing without a recorder. A value may be a
    function of no arguments (a count of device values, say): the
    recorder calls it only when its events are read, after the run, so
    the layer neither reads a device value nor queues work for it."""
    rec = _recorder
    if rec is not None:
        rec.note_span(name, args)
