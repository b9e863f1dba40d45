"""`model_ms_per_step` in a cell that holds its KV locally, where `tokens_per_s`
is not end to end: the same reading (`model_ms_per_step.py`), named for the
cell's other end-to-end metric, `peak_gib`."""
from portbench.harness import load_metric

_read = load_metric("model_ms_per_step")


def read(ctx):
    return _read(ctx)
