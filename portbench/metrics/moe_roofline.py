"""The expert layers over their roofline (%): the bytes their work needs
in the profiled steps (`moecounts.layer_bytes`, from the configuration's
shapes and each `model.moe` span's tokens and distinct routed experts)
at 3.35 TB/s, over the device time those spans own in the trace."""
from portbench import counts, moecounts


def read(ctx):
    got = moecounts.profiled(ctx)
    if got is None:
        return None
    inside, _, owned = got
    if owned["device_s"] <= 0 or any(
            not isinstance(e["args"].get("routed"), int) for e in inside):
        return None
    total = sum(moecounts.layer_bytes(ctx["config"], e["args"]["tokens"],
                                      e["args"]["routed"]) for e in inside)
    return 100.0 * total / counts.HBM_BYTES_PER_S / owned["device_s"]
