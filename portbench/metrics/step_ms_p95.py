"""95th percentile of the host-clock time of one decode step (ms): the
serve loop's own `decode_step` spans in a paged cell (model and store),
the harness's synchronised span around `decode_step` otherwise."""
import numpy as np


def read(ctx):
    if not ctx["step_ms"]:
        return None
    return float(np.percentile(np.asarray(ctx["step_ms"], dtype=float), 95))
