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
with a `where`, so the values are the same.

The forward composes with autograd, as the reference's does with
`jax.grad`, under GPipe's schedule: the activations of every in-flight
microbatch live until the backward. Each send's backward sends the
cotangent one stage back, and the broadcast's backward hands the last
stage its own cotangent of the outputs and the other stages none, where
the reference's `where(stage_id == s - 1, ...)` puts it. So when every
rank computes the same loss from the (replicated) outputs, the gradients
are those of ONE such loss, not S times it, as JAX's transpose of the
`psum` gives them. Every rank must backpropagate through the outputs:
the backward's sends are collective. They run in the reverse order of
the forward's on every rank, because each send's node takes a token
from the one before it, so the nodes form one chain whatever a stage
computes.
"""
from __future__ import annotations

import torch

from repro_torch.core.compute_plane import tree_leaves
from repro_torch.runtime.mesh_rules import axis_group, axis_index, axis_size


def _exchange(y, group, stage: int, s: int, step: int):
    """Stage i sends `y` to stage i + step (mod s) and returns what stage
    i - step sent it."""
    import torch.distributed as dist
    peer = lambda i: dist.get_global_rank(group, i % s)   # noqa: E731
    got = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(), peer(stage + step), group),
           dist.P2POp(dist.irecv, got, peer(stage - step), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


class _Shift(torch.autograd.Function):
    """y of every stage -> y of the previous stage; the backward moves
    the cotangent the other way. `token` chains the sends' nodes."""

    @staticmethod
    def forward(ctx, y, token, group, stage, s):
        ctx.comm = (group, stage, s)
        return _exchange(y, group, stage, s, 1), token.clone()

    @staticmethod
    def backward(ctx, g, g_token):
        return (_exchange(g, *ctx.comm, -1), g_token, None, None, None)


class _Broadcast(torch.autograd.Function):
    """The last stage's `buf` on every stage; the backward keeps the last
    stage's cotangent and gives the other stages none."""

    @staticmethod
    def forward(ctx, buf, token, group, stage, s):
        import torch.distributed as dist
        ctx.last = stage == s - 1
        out = buf.clone()
        dist.broadcast(out, dist.get_global_rank(group, s - 1), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else None, torch.zeros(()), None, None,
                None)


def _shift(y, token, group, stage: int, s: int):
    """(y of the previous stage, the next token); the identity on one
    stage."""
    if s == 1:
        return y, token
    return _Shift.apply(y, token, group, stage, s)


def pipeline_forward(mesh, stage_fn, stage_params, x_micro,
                     axis: str = "stage"):
    """Run microbatches through the S pipeline stages of `axis`.

    stage_params: this rank's stage's parameters (the reference's
    `stage_params[i]` on the rank at stage i); x_micro: (M, mb, ...)
    microbatches, the same on every rank (stage 0's gets the gradient);
    stage_fn(params, x) -> y, the same shape as x. Returns the (M, mb,
    ...) outputs of the last stage on every rank. The tensors that are to
    get gradients are in `stage_params` or `x_micro`, on every rank.
    """
    s = axis_size(mesh, axis)
    group = axis_group(mesh, axis)
    stage = axis_index(mesh, axis)
    m = x_micro.shape[0]
    # the chain of the sends' nodes starts at a token that needs a
    # gradient whenever autograd records this forward
    records = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in tree_leaves((stage_params, x_micro)))
    token = torch.zeros((), requires_grad=records)
    outs = []                                 # the last stage's outputs
    cur = torch.zeros_like(x_micro[0])
    for t in range(m + s - 1):
        # stage 0 injects microbatch t; the others use what arrived
        x_in = x_micro[t if t < m else 0] if stage == 0 else cur
        active = 0 <= t - stage < m
        y = stage_fn(stage_params, x_in) if active else cur
        if stage == s - 1 and active:
            outs.append(y)
        if t < m + s - 2:
            cur, token = _shift(y, token, group, stage, s)
    buf = torch.stack(outs) if outs else torch.zeros_like(x_micro)
    return _Broadcast.apply(buf, token, group, stage, s)
