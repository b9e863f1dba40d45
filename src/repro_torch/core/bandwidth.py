"""Approximate bandwidth partitioning (paper §4.1) as virtual channels.

PyTorch counterpart of ``repro.core.bandwidth``: the only home of
busy-until channel arithmetic. A busy-until clock per virtual channel
models the steady-state split of a link between cache lines (``ratio``
of the bandwidth) and pages (the rest); an un-partitioned link is one
shared FIFO. Every argument may be a tensor, and the gates are
`torch.where`s, not Python branches.

The partitioned/shared switch takes either type. A Python bool (the
store's static config) picks its branch on the host and adds no launch;
a bool tensor (the simulator's scheme flag, one per lattice point) takes
a `torch.where` path with the reference's arithmetic. The type of the
argument picks the path, as a constant does under `jit`.
"""
from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32

# Hard clamp of the adaptive line share, so the controller can never
# starve either granularity.
RATIO_MIN = 0.05
RATIO_MAX = 0.75


def occupy_busy(busy, t_ready, nbytes, bw, *, gate=True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serialize `nbytes` on a raw busy-until clock iff `gate`.
    Returns (new_busy, done); `done` is computed unconditionally."""
    start = torch.maximum(torch.as_tensor(t_ready, dtype=F32), busy)
    done = start + nbytes / torch.clamp(bw, min=1e-6)
    return torch.where(torch.as_tensor(gate, device=busy.device), done,
                       busy), done


def shares(partition, ratio) -> Tuple[torch.Tensor, torch.Tensor]:
    """(line_share, page_share) of the physical bandwidth (§4.1):
    `ratio` / `1 - ratio` when partitioned, 1 / 1 for a shared FIFO.
    `partition` is a Python bool or a bool tensor."""
    if isinstance(partition, bool):
        if partition:
            return ratio.to(F32), (1.0 - ratio).to(F32)
        one = torch.ones_like(ratio, dtype=F32)
        return one, one
    return (torch.where(partition, ratio, 1.0).to(F32),
            torch.where(partition, 1.0 - ratio, 1.0).to(F32))


def adapt_ratio(ratio, line_demand, page_demand, *, saturation, r_idle,
                gain=0.25, r_min=RATIO_MIN, r_max=RATIO_MAX
                ) -> torch.Tensor:
    """One adaptive-repartitioning control step: the carried ratio moves
    first-order (`gain`) toward the byte-proportional demand split,
    weighted by the module's `saturation`, and toward the seed ratio
    `r_idle` when idle; clamped to [r_min, r_max]."""
    total = line_demand + page_demand
    byte_prop = torch.where(total > 1e-6,
                            line_demand / torch.clamp(total, min=1e-6),
                            r_idle)
    sat = torch.clamp(saturation, 0.0, 1.0)
    target = sat * byte_prop + (1.0 - sat) * r_idle
    return torch.clamp(ratio + gain * (target - ratio), r_min, r_max)


def serve_dual(line_busy, page_busy, *, partition, ratio, bw,
               line_ready, line_bytes, line_gate,
               page_ready, page_bytes, page_gate
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """One dual-granularity service step on a physical link (§4.1).

    partition=True: two independent virtual channels. partition=False:
    one shared FIFO whose clock lives in `page_busy`; the line is served
    first at full bandwidth and the page queues behind it. `partition`
    is a Python bool or a bool tensor (`shares`).

    Returns (line_busy', page_busy', line_done, page_done)."""
    line_share, page_share = shares(partition, ratio)
    if isinstance(partition, bool):
        def pick(a, b):
            return a if partition else b
    else:
        def pick(a, b):
            return torch.where(partition, a, b)
    line_in = pick(line_busy, page_busy)
    lb, line_done = occupy_busy(line_in, line_ready, line_bytes,
                                bw * line_share, gate=line_gate)
    page_in = pick(page_busy, lb)
    pb, page_done = occupy_busy(page_in, page_ready, page_bytes,
                                bw * page_share, gate=page_gate)
    new_line = pick(lb, line_busy)
    return new_line, pb, line_done, page_done
