"""Pipeline parallelism (GPipe-style) over a `stage` mesh axis.

PyTorch counterpart of ``repro.runtime.pipeline``: the classic
(M + S - 1)-tick GPipe schedule over the S ranks of a mesh axis. Each
rank holds one stage's parameters; microbatches stream through, and at
every tick each stage's output moves to the next stage by point-to-point
sends over the axis's process group (the reference's `ppermute`). At
the end the last stage's outputs are broadcast to every stage (the
reference's `psum` of a buffer that only the last stage filled).

A stage computes only at the ticks where it holds a microbatch; the
reference computes at every tick and keeps the idle ticks' results out
with a `where`, so the values are the same. The forward is what is
ported: the sends carry no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.runtime.mesh_rules import axis_group, axis_index, axis_size


def _shift(y, group, stage: int, s: int):
    """y of every stage -> y of the previous stage (stage i sends to
    i + 1 mod s); the identity on one stage."""
    if s == 1:
        return y
    import torch.distributed as dist
    peer = lambda i: dist.get_global_rank(group, i % s)   # noqa: E731
    nxt = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(), peer(stage + 1), group),
           dist.P2POp(dist.irecv, nxt, peer(stage - 1), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return nxt


def pipeline_forward(mesh, stage_fn, stage_params, x_micro,
                     axis: str = "stage"):
    """Run microbatches through the S pipeline stages of `axis`.

    stage_params: this rank's stage's parameters (the reference's
    `stage_params[i]` on the rank at stage i); x_micro: (M, mb, ...)
    microbatches, the same on every rank; stage_fn(params, x) -> y, the
    same shape as x. Returns the (M, mb, ...) outputs of the last stage
    on every rank.
    """
    s = axis_size(mesh, axis)
    group = axis_group(mesh, axis)
    stage = axis_index(mesh, axis)
    m = x_micro.shape[0]
    buf = torch.zeros_like(x_micro)          # completed outputs
    cur = torch.zeros_like(x_micro[0])
    for t in range(m + s - 1):
        # stage 0 injects microbatch t; the others use what arrived
        x_in = x_micro[t if t < m else 0] if stage == 0 else cur
        y = stage_fn(stage_params, x_in) if 0 <= t - stage < m else cur
        if stage == s - 1 and 0 <= t - stage < m:
            buf[t - stage] = y
        if t < m + s - 2:
            cur = _shift(y, group, stage, s)
    import torch.distributed as dist
    dist.broadcast(buf, dist.get_global_rank(group, s - 1), group=group)
    return buf
