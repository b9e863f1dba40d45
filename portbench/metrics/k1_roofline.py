"""K1 (`residency_fused`) over its roofline (%): the bytes its inputs
need in the traced steps (`counts.k1_bytes`, the landings per step from
the store reference) at 3.35 TB/s, over its device time in the trace.
One launch per traced step, or nothing is read."""
from portbench import counts, devtrace


def read(ctx):
    tr, per_step, g = ctx["trace"], ctx["store_per_step"], ctx["geometry"]
    if tr is None or per_step is None:
        return None
    secs, launches = devtrace.kernel(tr, "residency_fused_kernel")
    first, last = ctx["trace_steps"]
    if launches != last - first or secs <= 0:
        return None
    b = ctx["traffic"]["batch"]
    req = ctx["traffic"]["paged"]["window_pages"]
    total = sum(counts.k1_bytes(b, g["num_local_pages"], 256, req,
                                counts.row_bytes(g), landed)
                for landed in per_step["landings"])
    return 100.0 * total / counts.HBM_BYTES_PER_S / secs
