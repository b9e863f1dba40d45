"""`device_idle_share` in a cell that holds its KV locally, where `tokens_per_s`
is not end to end: the same reading (`device_idle_share.py`), named for the
cell's other end-to-end metric, `peak_gib`."""
from portbench.harness import load_metric

_read = load_metric("device_idle_share")


def read(ctx):
    return _read(ctx)
