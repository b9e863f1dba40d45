"""Device ms of the expert layers per profiled step: the union of the
intervals of the device work that the profiled steps' `model.moe` spans
launched (`spans.attribute`: the innermost span owns a launch, so the
`model.decode` span keeps the rest of the model), over the profiled
steps. Nothing to read where no MoE layer runs or the program records
no such span."""
from portbench import moecounts


def read(ctx):
    got = moecounts.profiled(ctx)
    if got is None:
        return None
    _, steps, owned = got
    return 1e3 * owned["device_s"] / steps
