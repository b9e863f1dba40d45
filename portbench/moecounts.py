"""The expert layers' work, read from the program's `model.moe` spans:
which of them lie in the profiled steps, and the bytes their work needs
(the numerator of `moe_roofline`).

A layer's bytes are counted from the configuration's shapes and the
span's recorded routing, whatever implements the layer: each routed
expert's three weight matrices (gate, up, down) read once, the router
read once, and the tokens' rows read in and written out once, in the
configuration's type. An implementation that reads every expert's
weights (`moe_dense`) does more than this work, one that reads only the
routed experts' does no less, so the share cannot pass 100 %.
"""
from __future__ import annotations

import torch

from portbench import spans

SPAN = "model.moe"


def layer_bytes(cfg: dict, tokens: int, routed: int) -> int:
    """Bytes one expert layer's work needs for `tokens` tokens routed to
    `routed` distinct experts."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    item = getattr(torch, cfg["torch_dtype"]).itemsize
    return item * (routed * 3 * d * f + d * cfg["num_experts"]
                   + 2 * tokens * d)


def profiled(ctx):
    """(the profiled steps' `model.moe` events, how many profiled steps
    hold one, the device launches and seconds the spans own), or None
    without the spans or a profiled window."""
    events, owned = ctx.get("span_events"), ctx.get("span_devices")
    if not events or owned is None or SPAN not in owned:
        return None
    inside, _ = spans.split_steps(events, SPAN, ctx["trace_steps"])
    if not inside:
        return None
    where = spans.step_index(events)
    steps = len({where[e["args"]["id"]] for e in inside})
    return inside, steps, owned[SPAN]
