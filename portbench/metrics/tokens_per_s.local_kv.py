"""Tokens a second of a traced run, in a cell where `tokens_per_s` is
not end to end: each completed call's prompt and new tokens over its
seconds, as `tokens_per_s` counts them, leaving out every call that
holds a profiled step (the profiler's start, trace and stop are in its
seconds). The other calls carry the traced run's synchronised wraps, so
it reads below an untraced run's rate."""
from portbench import cell


def read(ctx):
    tr, (first, last) = ctx["traffic"], ctx["trace_steps"]
    tokens, secs, start = 0, 0.0, 0
    for c, s in enumerate(ctx["call_s"]):
        p, n = cell.call_lengths(tr, c)
        if start + p + n <= first or start >= last:
            tokens, secs = tokens + p + n, secs + s
        start += p + n
    return tr["batch"] * tokens / secs if secs > 0 else None
