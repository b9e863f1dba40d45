"""`step_mfu` in a cell that holds its KV locally, where `tokens_per_s`
is not end to end: the same reading (`step_mfu.py`), named for the
cell's other end-to-end metric, `peak_gib`."""
from portbench.harness import load_metric

_read = load_metric("step_mfu")


def read(ctx):
    return _read(ctx)
