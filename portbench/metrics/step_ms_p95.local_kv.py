"""`step_ms_p95` in a cell that holds its KV locally, where `tokens_per_s`
is not end to end: the same reading (`step_ms_p95.py`), named for the
cell's other end-to-end metric, `peak_gib`."""
from portbench.harness import load_metric

_read = load_metric("step_ms_p95")


def read(ctx):
    return _read(ctx)
