"""The program's layer spans against the device trace: each device
activity of the profiled window (kernel, copy, set) goes to the host
call that launched it (by the trace's `correlation_id`), then to the
innermost program span open at that call's start; per span name, the
launches and the device seconds (the union of its activities'
intervals, so overlapping work counts once).

A program span, here, is a host annotation whose name the program's
`SpanRecorder` recorded (`repro_torch.core.telemetry.span` opens a
`record_function` range of its name under a running profiler); the
harness's own labels (`portbench.*`, `daemon_store._*`) are other
annotations and own nothing. The recorder's events (Unix-epoch
microseconds) then give each span's step and counts: `step_index`
numbers the window's `serve.step` spans in order, which is the decode
step the harness's `Tracer` counts.
"""
from __future__ import annotations

from collections import defaultdict

# the host calls (the `cuda*` and `cu*` APIs) that queue device work;
# another call's device record (a synchronisation) is no launch
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")
UNATTRIBUTED = None


def _union_s(intervals) -> float:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-9


def profile_events(prof, names) -> tuple:
    """(activities [(start ns, end ns, correlation)], launches
    {correlation: start ns}, spans [(start ns, end ns, name)], dropped)
    of a `torch.profiler.profile`'s trace. `launches` are the host's
    CUDA API calls that queue work (kernels, copies, sets), `spans` the
    host annotations named in `names`; `dropped` counts the device
    records of other API calls (synchronisations), which are left out
    of `activities`, as are the device's mirrors of host annotations."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    dev, calls, spans = [], {}, []
    labels = set()
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            dev.append(e)
        elif e.is_user_annotation():
            labels.add(e.name())
            if e.name() in names:
                spans.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.name().startswith("cu"):
            calls[e.correlation_id()] = (e.start_ns(), e.name())
    launches = {c: t for c, (t, name) in calls.items()
                if any(w in name for w in LAUNCH_WORDS)}
    acts, dropped = [], 0
    for e in dev:
        if e.is_user_annotation() or e.name() in labels:
            continue
        corr = e.correlation_id()
        if corr in calls and corr not in launches:
            dropped += 1
            continue
        acts.append((e.start_ns(), e.end_ns(), corr))
    return acts, launches, spans, dropped


def attribute(activities, launches, spans) -> dict:
    """{span name: {"launches": n, "device_s": s}} for the activities
    whose launch call lies inside a span (the innermost: host spans of
    one thread nest), and the rest under `UNATTRIBUTED` (launched
    outside every span, or with no launch call in the trace)."""
    order = sorted(spans)
    owner = {}
    stack, i = [], 0
    for t, corr in sorted((t, c) for c, t in launches.items()):
        while i < len(order) and order[i][0] <= t:
            while stack and stack[-1][1] <= order[i][0]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        owner[corr] = stack[-1][2] if stack else UNATTRIBUTED
    per = defaultdict(list)
    for start, end, corr in activities:
        per[owner.get(corr, UNATTRIBUTED)].append((start, end))
    return {name: {"launches": len(iv), "device_s": _union_s(iv)}
            for name, iv in per.items()}


def attributed_share(attribution: dict) -> float:
    """The share of the activities that some span owns (0 to 1)."""
    total = sum(a["launches"] for a in attribution.values())
    lost = attribution.get(UNATTRIBUTED, {"launches": 0})["launches"]
    return (total - lost) / total if total else 0.0


def step_index(events) -> dict:
    """{span id: window decode step} of every layer span (an event with
    an `id`) at or under a `serve.step`: the window's `serve.step`
    events numbered from 0 in the order they started."""
    layer = [e for e in events if "id" in e["args"]]
    steps = sorted((e for e in layer if e["name"] == "serve.step"),
                   key=lambda e: e["ts"])
    index = {e["args"]["id"]: k for k, e in enumerate(steps)}
    parent = {e["args"]["id"]: e["args"]["parent"] for e in layer}
    out = {}
    for e in layer:
        sid = e["args"]["id"]
        while sid is not None and sid not in index:
            sid = parent.get(sid)
        if sid is not None:
            out[e["args"]["id"]] = index[sid]
    return out


def split_steps(events, name: str, trace_steps) -> tuple:
    """(events named `name` in the profiled steps, those in the
    others), by `step_index`; `trace_steps` is [first, last)."""
    first, last = trace_steps
    where = step_index(events)
    mine = [e for e in events if e["name"] == name
            and e["args"].get("id") in where]
    inside = [e for e in mine if first <= where[e["args"]["id"]] < last]
    outside = [e for e in mine if not first <= where[e["args"]["id"]] < last]
    return inside, outside
