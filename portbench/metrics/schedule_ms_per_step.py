"""Host ms of the store's fabric schedule per decode step: the program's
`store.schedule` spans (`repro_torch.core.telemetry.span`, recorded by
a `SpanRecorder` active over the window), the profiled steps left out,
since profiling slows them. Nothing to read without the spans or where
no store runs."""
from portbench import spans


def read(ctx):
    events = ctx.get("span_events")
    if not events:
        return None
    _, rest = spans.split_steps(events, "store.schedule", ctx["trace_steps"])
    return sum(e["dur"] for e in rest) / 1e3 / len(rest) if rest else None
