"""Device launches of the model's decode per profiled step: the
kernels, copies and sets that the `model.decode` spans launched
(`spans.attribute`), over the profiled steps' `model.decode` spans. An
exact count: one seed gives one reading."""
from portbench import spans


def read(ctx):
    events, owned = ctx.get("span_events"), ctx.get("span_devices")
    if not events or owned is None or "model.decode" not in owned:
        return None
    inside, _ = spans.split_steps(events, "model.decode", ctx["trace_steps"])
    return owned["model.decode"]["launches"] / len(inside) if inside \
        else None
