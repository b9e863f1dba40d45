"""One run of one cell with the port's layer spans on.

    python3 portbench/spanrun.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Runs `harness.run_cell` as `run.py` does, with a `SpanRecorder` of the
port active over the window's calls (the set-up's warm call runs
without it): with `--trace 1` the one the harness's traced run makes
active itself, with `--trace 0` one of this script's. It prints
`run.py`'s result line with one more key, `spans`:

- `per_step`: the recorder's events per window step, and `span_us`:
  the host microseconds of one span, entered and left, with no recorder
  and with one;
- `host_ms`: per span name, the mean and 95th percentile of its host
  ms, the profiled steps left out (`serve.step` also over the decode
  phase alone, `serve.step.decode`);
- with `--trace 1`: per span name the device launches and device ms of
  the profiled steps (`spans.attribute`), the share of the profiled
  window's device launches that some span owns, and the readings of
  the span metrics (`metrics/<name>.py`, `SPAN_METRICS`).

With `--trace 0` the recorder's cost shows in `tokens_per_s` against an
untraced run of `run.py`. The harness's files are used as they are: the
untraced run's recorder is made active by wrapping `harness.make_entry`,
and the traced run's recorder and profiler are reached by wrapping
`harness.Tracer`, for this process alone.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from contextlib import contextmanager

T0 = time.perf_counter()

SPAN_METRICS = ("schedule_ms_per_step", "store_launches_per_request",
                "model_launches_per_step", "model_device_ms_per_step")


@contextmanager
def recording(harness, rec):
    """Patch `harness` for one run: unless `rec` is None, every call of
    the cell's entry after the first (the set-up's warm call) runs with
    `rec` active; the traced run's `Tracer` is appended to the list this
    yields."""
    make_entry, tracer_cls = harness.make_entry, harness.Tracer
    tracers = []

    class KeptTracer(tracer_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            tracers.append(self)

    def make(*args):
        call = make_entry(*args)
        made = []

        def recorded(prompts, new_tokens, recorder=None):
            made.append(None)
            if len(made) == 1:
                return call(prompts, new_tokens, recorder)
            with rec.active():
                return call(prompts, new_tokens, recorder)
        return recorded

    harness.Tracer = KeptTracer
    if rec is not None:
        harness.make_entry = make
    try:
        yield tracers
    finally:
        harness.make_entry, harness.Tracer = make_entry, tracer_cls


def span_cost_us(n: int = 20000) -> dict:
    """Host µs of one span entered and left: off, and with a recorder
    active (its events dropped after)."""
    from repro_torch.core import telemetry
    from repro_torch.runtime.obs import SpanRecorder
    out = {}
    for mode in ("off", "on"):
        rec = SpanRecorder()
        with (rec.active() if mode == "on" else telemetry.recording(None)):
            t = time.perf_counter()
            for _ in range(n):
                with telemetry.span("store.step", requests=64):
                    pass
            out[mode] = (time.perf_counter() - t) / n * 1e6
    return out


def _ms(events) -> dict:
    ms = [e["dur"] / 1e3 for e in events]
    return {"n": len(ms), "mean": statistics.fmean(ms),
            "p95": statistics.quantiles(ms, n=20)[-1] if len(ms) > 1
            else ms[0]}


def readings(spec: dict, events: list, tracer) -> dict:
    """The `spans` key of the result line (see the module's text)."""
    from portbench import harness, spans
    steps = spec["traffic"]["trace_steps"]
    where = spans.step_index(events)
    out = {"per_step": len(events) / max(len(set(where.values())), 1),
           "span_us": span_cost_us(), "host_ms": {}}
    names = sorted({e["name"] for e in events})
    for name in names:
        _, rest = spans.split_steps(events, name, steps)
        if rest:
            out["host_ms"][name] = _ms(rest)
    _, rest = spans.split_steps(events, "serve.step", steps)
    decode = [e for e in rest if e["args"]["phase"] == "decode"]
    if decode:
        out["host_ms"]["serve.step.decode"] = _ms(decode)
    owned = None
    if tracer is not None and tracer.window is not None:
        acts, launches, annotated, dropped = spans.profile_events(
            tracer.prof, set(names))
        owned = spans.attribute(acts, launches, annotated)
        out["activities"], out["launch_calls"] = len(acts), len(launches)
        out["unlaunched"] = sum(1 for a in acts if a[2] not in launches)
        out["dropped"] = dropped
        out["attributed_share"] = spans.attributed_share(owned)
        out["devices"] = {str(k): {"launches": v["launches"],
                                   "device_ms": v["device_s"] * 1e3}
                          for k, v in owned.items()}
    ctx = {"span_events": events, "span_devices": owned,
           "trace_steps": steps}
    out["metrics"] = {m: harness.load_metric(m)(ctx) for m in SPAN_METRICS}
    return out


def run_spans(spec: dict, seed: int, seconds: float, trace: bool, device,
              t0: float) -> dict:
    """`harness.run_cell` with the spans on; its result with `spans`."""
    from portbench import harness
    from repro_torch.runtime.obs import SpanRecorder
    rec = None if trace else SpanRecorder()
    with recording(harness, rec) as tracers:
        result = harness.run_cell(spec, seed, seconds, trace, device, t0)
    tracer = tracers[0] if tracers else None
    events = tracer.recorder.events if trace else rec.events
    result["spans"] = readings(spec, events, tracer)
    return result


def main(argv=None) -> int:
    import run
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    run._paths()
    import torch
    from portbench import cell
    spec = cell.load(args.workload)
    if not torch.cuda.is_available():
        print("spanrun: needs a CUDA device", file=sys.stderr)
        return 2
    result = run_spans(spec, args.seed, args.seconds, bool(args.trace),
                       "cuda", T0)
    return run.report(result)


if __name__ == "__main__":
    sys.exit(main())
