"""K2 (`paged_gather`, the K and V pair of the critical fetch) over its
roofline (%): the bytes its inputs need in the traced steps
(`counts.k2_bytes`, the misses per step from the store reference) at
3.35 TB/s, over its device time in the trace. One launch per traced
step, or nothing is read."""
from portbench import counts, devtrace


def read(ctx):
    tr, per_step, g = ctx["trace"], ctx["store_per_step"], ctx["geometry"]
    if tr is None or per_step is None:
        return None
    secs, launches = devtrace.kernel(tr, "paged_gather_kernel")
    first, last = ctx["trace_steps"]
    if launches != last - first or secs <= 0:
        return None
    lookups = ctx["traffic"]["batch"] * ctx["traffic"]["paged"]["window_pages"]
    total = sum(counts.k2_bytes(lookups, missed, counts.row_bytes(g))
                for missed in per_step["misses"])
    return 100.0 * total / counts.HBM_BYTES_PER_S / secs
