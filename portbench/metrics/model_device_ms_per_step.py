"""Device ms of the model's decode per profiled step: the union of the
intervals of the device work that the `model.decode` spans launched
(`spans.attribute`), over the profiled steps' `model.decode` spans. A
device-side reading of the model layer, beside the host-paced
`model_ms_per_step`."""
from portbench import spans


def read(ctx):
    events, owned = ctx.get("span_events"), ctx.get("span_devices")
    if not events or owned is None or "model.decode" not in owned:
        return None
    inside, _ = spans.split_steps(events, "model.decode", ctx["trace_steps"])
    return 1e3 * owned["model.decode"]["device_s"] / len(inside) if inside \
        else None
