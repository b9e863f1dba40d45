"""The device trace of a traced run, reduced: the seconds in which the
device ran anything (the union of its kernel, copy and set intervals),
the time and launches of each kernel by name, and the idle gaps between
device intervals, each labelled with the innermost host annotation open
at its start (the harness's `portbench.*` spans and the store's parts).
"""
from __future__ import annotations

from collections import defaultdict


def _device_events(prof):
    """(device activity, host annotations), each [(start ns, end ns,
    name)]. The trace mirrors each annotation onto the device's
    timeline; those copies are not device work and are left out."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    host = [(e.start_ns(), e.end_ns(), e.name()) for e in events
            if e.is_user_annotation() and e.device_type() != DeviceType.CUDA]
    labels = {name for _, _, name in host}
    dev = [(e.start_ns(), e.end_ns(), e.name()) for e in events
           if e.device_type() == DeviceType.CUDA
           and not e.is_user_annotation() and e.name() not in labels]
    return dev, host


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _label(t, host) -> str:
    """The innermost (latest started) annotation open at time `t`."""
    best = None
    for start, end, name in host:
        if start <= t < end and (best is None or start > best[0]):
            best = (start, name)
    return best[1] if best else "harness"


def summarize(prof, window_s: float, top: int = 10) -> dict:
    """busy_s, window_s, per-kernel seconds and launches, and the idle
    gaps' seconds by host label (each list of the `top` largest)."""
    dev, host = _device_events(prof)
    merged = _union((s, e) for s, e, _ in dev)
    busy_ns = sum(e - s for s, e in merged)
    kernels = defaultdict(lambda: [0.0, 0])
    for start, end, name in dev:
        kernels[name][0] += (end - start) * 1e-9
        kernels[name][1] += 1
    gaps = defaultdict(float)
    host.sort()
    for (_, prev_end), (start, _) in zip(merged, merged[1:]):
        gaps[_label(prev_end, host)] += (start - prev_end) * 1e-9
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {"busy_s": busy_ns * 1e-9, "window_s": window_s,
            "kernels": {k: v for k, v in kernels.items()},
            "device_ops": [[k, v[0]] for k, v in ops[:top]],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:top]}


def kernel(summary: dict, fragment: str):
    """(seconds, launches) of the kernels whose name holds `fragment`."""
    secs, n = 0.0, 0
    for name, (s, c) in summary["kernels"].items():
        if fragment in name:
            secs += s
            n += c
    return secs, n
