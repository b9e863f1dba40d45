"""Mixture-of-Experts: top-k routing, the dense combine and expert
parallelism.

PyTorch counterpart of ``repro.models.moe``. Two implementations:

* `moe_dense` — every expert runs on every token and the combine masks
  by the routing weights, as the reference's oracle does.
* `moe_ep` — expert parallelism over the `model` axis of the active
  mesh (``runtime.mesh_rules.use_mesh``): each rank takes its block of
  the tokens, sort-groups their (token, expert) slots by destination
  rank (capacity-bounded), exchanges them with an all-to-all over the
  axis's process group, sort-groups them again by local expert, runs its
  E / m experts as batched products on the grouped buffers, and sends
  the results back the same way; the token blocks are then gathered.
  The exchanges are ``torch.distributed.nn.functional.all_to_all_single``,
  so gradients flow through them. As the reference's, slots beyond a
  capacity are dropped (their expert contributes nothing), so `moe_ep`
  can differ from `moe_dense` where tokens crowd an expert.

Top-k ties go to the lower expert index, as `jax.lax.top_k` breaks them:
the k experts are the first k of a stable descending sort, which orders
alike on the CPU and on the card (`torch.topk` does not promise an order
among equal values). The chosen experts are weighted by the softmax over
their k logits, or with `cfg.norm_topk_prob` False (OLMoE) by the
softmax over all the experts' logits, not renormalised.

`moe` is one layer's call, inside the layer span `model.moe` (tokens,
experts, k; and `routed`, the number of distinct experts the tokens were
routed to, which the span's recorder reads from the routing only when
its events are read, so the step reads no device value for it).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import telemetry
from repro_torch.models.layers import F32, dot, normal, silu
from repro_torch.runtime.mesh_rules import (active_mesh, axis_group,
                                            axis_index, axis_size,
                                            dp_axis_names, is_dtensor,
                                            mesh_shape, outside_fake_mode)


def init_moe(gen: torch.Generator, cfg, *, layers: int = 0, dtype=F32):
    """Router (D, E) and the experts' SwiGLU weights (E, D, F), (E, D, F),
    (E, F, D), each drawn at the reference's scale (1/sqrt of the leading
    dimension; 0.02 for the router); `layers` > 0 stacks them."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": normal(gen, (d, e), scale=0.02, layers=layers,
                             dtype=dtype),
            "w_gate": normal(gen, (e, d, f), layers=layers, dtype=dtype),
            "w_up": normal(gen, (e, d, f), layers=layers, dtype=dtype),
            "w_down": normal(gen, (e, f, d), layers=layers, dtype=dtype)}


def moe_axes():
    """Logical axes of `init_moe`'s parameters."""
    ex = ("experts", "fsdp", None)
    return {"router": (None, None), "w_gate": ex, "w_up": ex,
            "w_down": ex}


def top_k_lowest_first(x, k: int):
    """(values, indices) of the k largest entries of the last axis, in
    descending order, equal values by ascending index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, cfg, x):
    """Returns (weights (B,S,k) f32, idx (B,S,k) int64, aux_loss scalar):
    the k largest router logits' experts, weighted by the softmax over
    those k logits (`cfg.norm_topk_prob`) or over all of them, and the
    Switch-style load-balance loss E * sum_e importance_e * load_e."""
    logits = dot(x, params["router"].to(x.dtype), "bsd,de->bse")
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    top_w, top_i = top_k_lowest_first(logits, k)
    if cfg.norm_topk_prob:
        top_w = torch.softmax(top_w, dim=-1)
    else:
        top_w = probs.gather(-1, top_i)
    telemetry.note("model.moe",
                   routed=lambda: int(torch.unique(top_i).numel()))
    e = cfg.num_experts
    importance = probs.mean(dim=(0, 1))
    flat = top_i.reshape(-1)
    # integer-valued f32 sums are exact in any order; bincount would read
    # the largest index back to the host, and DTensor has no rule for an
    # index_add into a sharded axis on every version
    counts = (flat[:, None] == torch.arange(e, device=x.device)).to(
        F32).sum(0)
    load = counts / top_i.numel()
    aux = e * torch.sum(importance * load)
    return top_w, top_i, aux


def moe_dense(params, cfg, x):
    """All experts on all tokens, masked combine. x (B,S,D) -> ((B,S,D),
    aux)."""
    dtype = x.dtype
    w, idx, aux = _route(params, cfg, x)
    e = cfg.num_experts
    experts = torch.arange(e, device=x.device)
    gates = ((idx[..., None] == experts).to(F32) * w[..., None]).sum(-2)
    g = dot(x, params["w_gate"].to(dtype), "bsd,edf->bsef")
    u = dot(x, params["w_up"].to(dtype), "bsd,edf->bsef")
    h = (silu(g) * u).to(dtype)
    y = dot(h, params["w_down"].to(dtype), "bsef,efd->bsed")
    y = (y * gates[..., None]).sum(dim=2)
    return y.to(dtype), aux


# --------------------------------------------------------------------------
# expert-parallel path
# --------------------------------------------------------------------------
def _round8(n: int) -> int:
    return max(8, ((n + 7) // 8) * 8)


def _group_by(ids, num_groups: int, capacity: int, payload):
    """Sort-group rows of `payload` by `ids` into (num_groups, capacity, D).

    Returns (buffer, order, dst, keep) so callers can invert the grouping:
    row j of the sorted order landed at flat slot dst[j] (the overflow
    slot num_groups*capacity when its group exceeded capacity or its id
    is not a group; the reference's scatter drops those rows and its
    gather clamps to the zero row, which the overflow slot is here).
    """
    n = ids.shape[0]
    order = torch.sort(ids, stable=True).indices
    sids = ids[order]
    groups = torch.arange(num_groups, device=ids.device, dtype=ids.dtype)
    first = torch.searchsorted(sids, groups)
    pos = torch.arange(n, device=ids.device) - first[
        sids.clamp(max=num_groups - 1)]
    keep = pos < capacity
    overflow = num_groups * capacity
    dst = torch.where(keep, sids * capacity + pos, overflow).clamp(
        max=overflow)
    rows = payload[order] * keep[:, None].to(payload.dtype)
    buf = payload.new_zeros((overflow + 1, payload.shape[1])).index_put(
        (dst,), rows)
    return buf[:-1].reshape(num_groups, capacity, -1), order, dst, keep


def _ungroup(buf_flat, order, dst, keep, n):
    """Inverse of _group_by for a result buffer of the same layout."""
    pad = torch.cat([buf_flat, buf_flat.new_zeros((1, buf_flat.shape[1]))])
    y_sorted = pad[dst] * keep[:, None].to(buf_flat.dtype)
    return buf_flat.new_zeros((n, buf_flat.shape[1])).index_put(
        (order,), y_sorted)


def _all_to_all(x, group):
    """Chunk i of x's rows to rank i of `group`; chunks received stacked
    by source rank (the reference's untiled `all_to_all` over dim 0)."""
    import torch.distributed.nn.functional as dist_fn
    x = x.contiguous()
    return dist_fn.all_to_all_single(torch.empty_like(x), x, group=group)


def _ep_local(group, e_total, k, cf, xl, idxl, wl, wg, wu, wd):
    """Per-rank EP body.

    xl (Tl, D) this rank's tokens; idxl (Tl, k) global expert ids; wl
    (Tl, k). wg/wu/wd: (E_local, D, F) / (E_local, F, D) this rank's
    expert weights.
    """
    e_local = wg.shape[0]
    m = e_total // e_local
    tl, d = xl.shape
    nslots = tl * k
    slot_expert = idxl.reshape(-1)
    slot_token = torch.arange(nslots, device=xl.device) // k
    dest = slot_expert // e_local

    cs = _round8(int(math.ceil(nslots / m * cf)))
    # payload: features + local expert id + valid flag
    meta = torch.stack([(slot_expert % e_local).to(xl.dtype),
                        torch.ones((nslots,), dtype=xl.dtype,
                                   device=xl.device)], dim=1)
    payload = torch.cat([xl[slot_token], meta], dim=1)
    send, order, dst, keep = _group_by(dest, m, cs, payload)

    recv = _all_to_all(send.reshape(m * cs, d + 2), group)
    feats, eid_f, valid = recv[:, :d], recv[:, d], recv[:, d + 1]
    eid = torch.where(valid > 0.5, eid_f.to(torch.int64), e_local)

    ce = _round8(int(math.ceil(m * cs / max(e_local, 1) * cf)))
    buf, order2, dst2, keep2 = _group_by(eid, e_local, ce, feats)
    g = dot(buf, wg.to(buf.dtype), "ecd,edf->ecf")
    u = dot(buf, wu.to(buf.dtype), "ecd,edf->ecf")
    h = (silu(g) * u).to(buf.dtype)
    yb = dot(h, wd.to(buf.dtype), "ecf,efd->ecd").to(buf.dtype)
    y_recv = _ungroup(yb.reshape(e_local * ce, d), order2, dst2, keep2,
                      m * cs)

    back = _all_to_all(y_recv, group)
    y_slot = _ungroup(back, order, dst, keep, nslots)
    return (y_slot.reshape(tl, k, d)
            * wl.reshape(tl, k, 1).to(y_slot.dtype)).sum(dim=1)


def _gather_rows(x, axes):
    """Row blocks over `axes` [(group, size, index)], outer first ->
    all blocks concatenated in rank order: an all-gather per axis,
    innermost first."""
    import torch.distributed as dist
    for group, size, _ in reversed(axes):
        if size > 1:
            parts = [torch.empty_like(x) for _ in range(size)]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts)
    return x


def _row_block(x, axes):
    """This rank's block of x's rows over `axes` (row-major in them)."""
    idx, n = 0, 1
    for _, size, index in axes:
        idx, n = idx * size + index, n * size
    rows = x.shape[0] // n
    return x[idx * rows:(idx + 1) * rows]


class _Shard(torch.autograd.Function):
    """Forward: this rank's row block of a tensor every rank holds
    alike. Backward: the blocks' gradients gathered, so every rank gets
    the whole gradient (the transpose of the reference's in_spec)."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _row_block(x, axes)

    @staticmethod
    def backward(ctx, grad):
        return _gather_rows(grad, ctx.axes), None


class _Unshard(torch.autograd.Function):
    """Forward: every rank's row block gathered. Backward: this rank's
    block of the gradient, which every rank holds alike (the transpose of
    the reference's out_spec)."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _gather_rows(x, axes)

    @staticmethod
    def backward(ctx, grad):
        return _row_block(grad, ctx.axes).contiguous(), None


class _SumGrad(torch.autograd.Function):
    """Forward: the identity. Backward: the gradient summed over the
    ranks of `axes`, which each saw other tokens."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.contiguous()
        for group, size, _ in ctx.axes:
            if size > 1:
                dist.all_reduce(grad, group=group)
        return grad, None


def _token_spec(mesh, t: int, axis_name: str):
    """Mesh axes the tokens are partitioned over for the EP region:
    data-parallel axes and `axis_name` when t divides over all of them,
    else `axis_name` alone, else None (the caller uses the dense path)."""
    sizes = mesh_shape(mesh)
    dp = dp_axis_names(mesh)
    for axes in (dp + (axis_name,), (axis_name,)):
        if t % math.prod(sizes[a] for a in axes) == 0:
            return axes
    return None


def moe_ep(params, cfg, x, axis_name: str = "model"):
    """Expert-parallel MoE over `axis_name` of the active mesh. x: (B,S,D)
    the same on every rank -> ((B,S,D), aux) the same on every rank.

    The expert weights are either the whole (E, ...) stacks, of which
    each rank uses its E / m experts, or this rank's (E / m, ...) shard;
    their gradients are this rank's experts' summed over the ranks that
    hold other tokens (and gathered over the experts for whole stacks).
    """
    mesh = active_mesh()
    if mesh is None or axis_name not in mesh_shape(mesh):
        raise ValueError(f"moe_ep needs an active mesh with a "
                         f"{axis_name!r} axis")
    b, s, d = x.shape
    e = cfg.num_experts
    m = axis_size(mesh, axis_name)
    tspec = _token_spec(mesh, b * s, axis_name)
    if tspec is None:
        if params["w_gate"].shape[0] != e:
            raise ValueError("a token count that does not split over the "
                             "mesh takes the dense path, which needs every "
                             "expert's weights")
        return moe_dense(params, cfg, x)
    w, idx, aux = _route(params, cfg, x)
    k = cfg.experts_per_token
    if is_dtensor(x):
        return _moe_ep_local_map(params, cfg, x, w, idx, mesh, tspec,
                                 axis_name), aux
    axes = [(axis_group(mesh, a), axis_size(mesh, a), axis_index(mesh, a))
            for a in tspec]
    xl = _Shard.apply(x.reshape(b * s, d), axes)
    idxl = _row_block(idx.reshape(b * s, k), axes)
    wl = _Shard.apply(w.reshape(b * s, k), axes)
    model = [ax for a, ax in zip(tspec, axes) if a == axis_name]
    others = [ax for a, ax in zip(tspec, axes) if a != axis_name]
    experts = []
    for name in ("w_gate", "w_up", "w_down"):
        wt = _SumGrad.apply(params[name], others)
        if wt.shape[0] == e and m > 1:
            wt = _Shard.apply(wt, model)
        experts.append(wt)
    yl = _ep_local(model[0][0], e, k, cfg.moe_capacity_factor, xl, idxl,
                   wl, *experts)
    y = _Unshard.apply(yl, axes)
    return y.reshape(b, s, d).to(x.dtype), aux


def _moe_ep_local_map(params, cfg, x, w, idx, mesh, tspec, axis_name):
    """`moe_ep` on DTensors: the per-rank body under ``local_map``, the
    counterpart of the reference's ``shard_map``. The tokens (and their
    routing) are split over the `tspec` mesh axes, the experts over
    `axis_name`; each rank runs `_ep_local` on its shards and the result
    comes back split over `tspec`, as DTensor placements say."""
    import functools

    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    b, s, d = x.shape
    k = cfg.experts_per_token
    names = list(mesh_shape(mesh))
    tok = tuple(Shard(0) if a in tspec else Replicate() for a in names)
    ex = tuple(Shard(0) if a == axis_name else Replicate() for a in names)
    body = functools.partial(_ep_local, axis_group(mesh, axis_name),
                             cfg.num_experts, k, cfg.moe_capacity_factor)
    xf = x.reshape(b * s, d)
    args = (xf, idx.reshape(b * s, k), w.reshape(b * s, k),
            params["w_gate"], params["w_up"], params["w_down"])
    with outside_fake_mode():
        y = local_map(body, out_placements=(tok,),
                      in_placements=(tok, tok, tok, ex, ex, ex),
                      device_mesh=mesh, redistribute_inputs=True)(*args)
        # back to the tokens' own placement (the exit all-gather), where
        # the (B, S) split of the token axis is well defined
        y = y.redistribute(mesh, tuple(
            Replicate() if p.is_partial() else p for p in xf.placements))
    return y.reshape(b, s, d).to(x.dtype)


def moe(params, cfg, x, impl: str = "dense"):
    """One MoE layer, x (B,S,D) -> ((B,S,D), aux), by `impl` ("dense":
    `moe_dense`, "ep": `moe_ep`), inside its `model.moe` span."""
    if impl not in ("dense", "ep"):
        raise ValueError(f"moe impl must be dense|ep, got {impl!r}")
    with telemetry.span("model.moe", tokens=x.shape[0] * x.shape[1],
                        experts=cfg.num_experts, k=cfg.experts_per_token):
        if impl == "ep":
            return moe_ep(params, cfg, x)
        return moe_dense(params, cfg, x)
