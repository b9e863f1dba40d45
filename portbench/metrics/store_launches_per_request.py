"""Device launches per store request: the kernels, copies and sets that
the profiled steps' `store.step` spans and their parts launched
(`spans.attribute`), over the requests those `store.step` spans
record. An exact count: one seed gives one reading."""
from portbench import spans


def read(ctx):
    events, owned = ctx.get("span_events"), ctx.get("span_devices")
    if not events or owned is None:
        return None
    inside, _ = spans.split_steps(events, "store.step", ctx["trace_steps"])
    requests = sum(e["args"]["requests"] for e in inside)
    launches = sum(a["launches"] for name, a in owned.items()
                   if name is not None and name.startswith("store."))
    return launches / requests if requests and launches else None
