"""Device launches of the expert layers per profiled step: the kernels,
copies and sets that the profiled steps' `model.moe` spans launched
(`spans.attribute`), over the profiled steps. An exact count: one seed
gives one reading."""
from portbench import moecounts


def read(ctx):
    got = moecounts.profiled(ctx)
    if got is None:
        return None
    _, steps, owned = got
    return owned["launches"] / steps if owned["launches"] else None
