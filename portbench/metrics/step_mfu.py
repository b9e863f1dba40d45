"""The whole step's share of the H100's dense bf16 peak (%): the model
FLOPs of the window's calls, counted from the configuration's shapes
(`counts.call_flops`), over their time at 989.4 TFLOP/s; the steps the
device trace records are left out of both, since profiling slows
them."""
from portbench import counts


def read(ctx):
    flops = sum(ctx["call_flops"]) - ctx["traced_flops"]
    secs = sum(ctx["call_s"]) - ctx["traced_s"]
    if flops <= 0 or secs <= 0:
        return None
    return 100.0 * flops / (secs * counts.PEAK_BF16_FLOPS)
