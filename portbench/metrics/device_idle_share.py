"""Share of the traced window in which no kernel, copy or set ran on the
device (%), from the profiler's trace."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["window_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
