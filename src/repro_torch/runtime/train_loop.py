"""Train step construction: grad accumulation, two DP-sync modes, AdamW.

PyTorch counterpart of ``repro.runtime.train_loop``. DP-sync modes (the
framework-level DaeMon experiment):

* ``none`` — the whole batch's gradients, accumulated over microbatches
  at full f32 width (the reference's bulk, page-granularity analogue).
* ``int8`` with ``num_pods > 1`` — DaeMon link compression applied to
  the pod link: the batch is split pod-major, each pod's gradients are
  computed and block-int8 quantized per leaf (blocks never straddle
  pods), exchanged as int8 plus f32 scales, then dequantized and
  averaged over pods in pod order. On a CUDA device quantize and
  dequantize are the hand-written kernels of ``csrc/qdq_int8.cu``
  (through ``core.compression`` and ``kernels.ops``).

The exchange is the reference's int8 all-gather over the pod axis.
Under an active mesh (``runtime.mesh_rules.use_mesh``) with a `pod`
axis of size G, rank g computes pods [g P/G, (g+1) P/G) of the P pods
and all-gathers each leaf's int8 payload and scales, and the per-pod
losses, over the pod axis's process group; every rank then dequantizes
every pod and applies the same update, bit-equal to the one-process
step. Without such a mesh one process computes every pod and the
exchange is the identity. Two things differ from the reference for
memory, not for values: pod p's gradients are quantized as soon as
they exist, so only one pod's f32 gradients are alive at a time, and
the optimizer updates the parameters and moments in place (see
``optim.adamw``). With ``dp_compress="none"`` every rank computes the
whole batch.

`train_step` takes an optional `on_stage(name)` callback, called after
each stage ("forward_backward", "pod_sync", "optimizer"); a caller that
times the stages synchronises the device there.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.compression import (dequantize_block_int8,
                                          quantize_block_int8)
from repro_torch.core.compute_plane import (tree_leaves, tree_map,
                                            tree_unflatten)
from repro_torch.models.model import ModelOptions, loss_fn
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.runtime.mesh_rules import (active_mesh, axis_group,
                                            axis_index, axis_size,
                                            constrain, is_dtensor,
                                            mesh_shape, outside_fake_mode)

F32 = torch.float32
DP_COMPRESS = ("none", "int8")


@dataclass(frozen=True)
class TrainConfig:
    adamw: AdamWConfig = AdamWConfig()
    warmup_steps: int = 100
    total_steps: int = 10000
    dp_compress: str = "none"        # "none" | "int8"
    quant_block: int = 256
    num_pods: int = 1                # pod-major batch splitting for "int8"


def _split_leading(x, n: int):
    """(B, ...) -> (n, B / n, ...), part i holding rows [i B/n, (i+1) B/n).
    A DTensor split over its batch axis is gathered first (the split of
    a mesh-divided axis is not a DTensor view) and its parts are then
    split over the batch axes again: the same rows as a plain tensor's,
    at the cost of one all-gather of the batch."""
    x = constrain(x, (None,) * x.ndim)
    y = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    return constrain(y, (None, "batch") + (None,) * (x.ndim - 1))


def _reshape_micro(batch, n_micro: int):
    return tree_map(lambda x: _split_leading(x, n_micro), batch)


def split_pods(batch, num_pods: int):
    """The global batch as `num_pods` pod-major sub-batches."""
    stacked = tree_map(lambda x: _split_leading(x, num_pods), batch)
    return [tree_map(lambda x: x[p], stacked) for p in range(num_pods)]


def _loss_and_grad_fn(cfg: ArchConfig, opt: ModelOptions):
    """(params, microbatch) -> ((loss, metrics), grads), grads shaped
    like params (f32 for f32 params)."""
    def loss_and_grad(params, mb):
        live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(params, live), cfg, mb,
                                    opt)
            grads = torch.autograd.grad(loss, live)
        return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
                tree_unflatten(params, grads))
    return loss_and_grad


def _accum_grads(loss_and_grad, params, micro_batch, n_micro):
    """Loop over microbatches with f32 gradient accumulation. Returns
    (mean grads, mean loss, per-microbatch metrics stacked)."""
    acc = None
    loss_sum = torch.zeros((), dtype=F32)
    metrics = []
    for i in range(n_micro):
        mb = tree_map(lambda x: x[i], micro_batch)
        (loss, m), grads = loss_and_grad(params, mb)
        g32 = [g.to(F32) for g in tree_leaves(grads)]
        if acc is None:                # a broadcast grad cannot add_ in place
            acc = [g if g.is_contiguous() else g.contiguous() for g in g32]
        else:
            for a, g in zip(acc, g32):
                a.add_(g)
        del grads, g32
        loss_sum = loss_sum.to(loss.device) + loss
        metrics.append(m)
    grads = tree_unflatten(params, [a.div_(n_micro) for a in acc])
    stacked = {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
    return grads, loss_sum / n_micro, stacked


def make_grads_fn(cfg: ArchConfig, opt: ModelOptions):
    """(params, batch) -> (grads, loss): the batch's gradients averaged
    over cfg.grad_accum_microbatches microbatches."""
    n_micro = max(1, cfg.grad_accum_microbatches)
    loss_and_grad = _loss_and_grad_fn(cfg, opt)

    def grads_of(params, batch):
        micro = _reshape_micro(batch, n_micro)
        grads, loss, _ = _accum_grads(loss_and_grad, params, micro, n_micro)
        return grads, loss

    return grads_of


def _quantize_pod(grads, block: int):
    """One pod's gradients -> [(q, scales)] per leaf, in leaf order."""
    return [quantize_block_int8(g, block) for g in tree_leaves(grads)]


def _pod_axis():
    """(process group, size G, this rank's index) of the active mesh's
    `pod` axis; (None, 1, 0) without one."""
    mesh = active_mesh()
    if mesh is None or "pod" not in mesh_shape(mesh):
        return None, 1, 0
    return (axis_group(mesh, "pod"), axis_size(mesh, "pod"),
            axis_index(mesh, "pod"))


def _gather_pods(local, group, size):
    """One tensor per pod of this rank -> one per pod of every rank, in
    pod order (rank-major): the all-gather over `group`, the identity
    without one."""
    if group is None:
        return list(local)
    import torch.distributed as dist
    out = [None] * (len(local) * size)
    for j, x in enumerate(local):
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        for r, part in enumerate(parts):
            out[r * len(local) + j] = part
    return out


def _dequantize_mean(pods_q, like, block: int, group=None, size: int = 1):
    """Mean over pods of the dequantized per-leaf gradients, as a tree
    shaped like `like`. `pods_q` holds this rank's pods; with a `group`
    each leaf's int8 payload and scales are first gathered from every
    rank, one leaf at a time."""
    out = []
    for i, leaf in enumerate(tree_leaves(like)):
        qs = _gather_pods([pod[i][0] for pod in pods_q], group, size)
        scales = _gather_pods([pod[i][1] for pod in pods_q], group, size)
        total = None
        for q, scale in zip(qs, scales):
            deq = dequantize_block_int8(q, scale, tuple(leaf.shape), block)
            total = deq if total is None else total + deq
        del qs, scales
        out.append(total / (len(pods_q) * size))
    return tree_unflatten(like, out)


def _compressed_pod_sync(grads_stack, num_pods: int, block: int):
    """grads_stack: tree with a leading (num_pods,) axis, every pod on
    this process.

    int8-quantize each pod's partial gradients per leaf, dequantize and
    average over pods."""
    pods = [tree_map(lambda g: g[p], grads_stack) for p in range(num_pods)]
    return _dequantize_mean([_quantize_pod(g, block) for g in pods],
                            pods[0], block)


def _block_aligned(leaf_placements, shape, sizes, block: int) -> bool:
    """Whether each rank's shard of a leaf of `shape` placed by
    `leaf_placements` (one per mesh axis of `sizes`) is a contiguous,
    `block`-aligned range of the leaf's row-major flattening: the leaf
    is whole, or split evenly on dim 0 only into shards of a multiple of
    `block` values. Such a shard's blocks are the whole leaf's."""
    from torch.distributed.tensor import Replicate, Shard
    parts = 1
    for p, n in zip(leaf_placements, sizes):
        if isinstance(p, Replicate) or n == 1:
            continue
        if type(p) is not Shard or p.dim != 0:
            return False
        parts *= n
    if parts == 1:
        return True
    return shape[0] % parts == 0 and math.prod(shape) // parts % block == 0


def _pod_sync_local_map(grads_stack, block: int):
    """`_compressed_pod_sync` on DTensors whose leading axis is split
    over the mesh's `pod` axis, under ``local_map`` (the counterpart of
    the reference's ``shard_map``): each pod's leaf is quantized in the
    whole leaf's `block`-value blocks, the int8 payload and scales are
    all-gathered over the pod axis's group, and every pod is dequantized
    and averaged in pod order, bit-equal to the unsharded sync. A leaf
    whose shards are block-aligned ranges of it (`_block_aligned`) is
    quantized shard by shard; any other is first gathered over the
    other mesh axes, synced whole, and returned in its placements. The
    result is each leaf without its pod axis, replicated over `pod` and
    split as before elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    leaves = tree_leaves(grads_stack)
    mesh = leaves[0].device_mesh
    shape = mesh_shape(mesh)
    names, sizes = list(shape), list(shape.values())
    group, size = axis_group(mesh, "pod"), axis_size(mesh, "pod")

    def drop_pod_axis(pl):
        return tuple(Replicate() if n == "pod" else
                     (Shard(p.dim - 1) if isinstance(p, Shard) else p)
                     for n, p in zip(names, pl))

    def whole(pl):
        return tuple(p if n == "pod" else Replicate()
                     for n, p in zip(names, pl))

    want = [drop_pod_axis(t.placements) for t in leaves]
    aligned = [_block_aligned(w, t.shape[1:], sizes, block)
               for w, t in zip(want, leaves)]

    def body(*stacks):
        per = stacks[0].shape[0]
        pods_q = [[quantize_block_int8(s[p], block) for s in stacks]
                  for p in range(per)]
        return tuple(_dequantize_mean(pods_q, [s[0] for s in stacks], block,
                                      group, size))

    with outside_fake_mode():
        ins = [t if a else t.redistribute(mesh, whole(t.placements))
               for t, a in zip(leaves, aligned)]
        out = local_map(body,
                        out_placements=tuple(drop_pod_axis(t.placements)
                                             for t in ins),
                        in_placements=tuple(t.placements for t in ins),
                        device_mesh=mesh, redistribute_inputs=False)(*ins)
        out = [o if a else o.redistribute(mesh, w)
               for o, a, w in zip(out, aligned, want)]
    return tree_unflatten(grads_stack, list(out))


def _sharded_pod_grads(grads_of, params, batch, tcfg: TrainConfig):
    """The int8 pod step's gradients on DTensors: this rank's pods are
    computed on its pod's (data, model) sub-mesh — the parameters are
    replicated over `pod` and the batch is split pod-major — and their
    gradients, stacked pod-major over the `pod` axis, go through
    `_pod_sync_local_map`. Returns (grads on the whole mesh, mean loss
    over every pod)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = active_mesh()
    names = list(mesh_shape(mesh))
    if names[0] != "pod":
        raise ValueError("the sharded int8 pod sync needs `pod` as the "
                         "mesh's first axis")
    sub = mesh[tuple(names[1:])]
    group, size = axis_group(mesh, "pod"), axis_size(mesh, "pod")
    per = tcfg.num_pods // size

    def to_sub(t):
        return DTensor.from_local(t.to_local(), sub, t.placements[1:],
                                  run_check=False)

    with outside_fake_mode():
        sub_params = tree_map(to_sub, params)
        sub_batch = tree_map(to_sub, batch)
    stacks, losses = None, []
    for pod_batch in split_pods(sub_batch, per):
        grads, loss = grads_of(sub_params, pod_batch)
        with outside_fake_mode():
            local = [g.redistribute(sub, p.placements).to_local()
                     for g, p in zip(tree_leaves(grads),
                                     tree_leaves(sub_params))]
            # the pod's whole loss (a `Partial` loss sums over the
            # sub-mesh here)
            if is_dtensor(loss):
                loss = loss.full_tensor()
        stacks = [[x] for x in local] if stacks is None else \
            [s + [x] for s, x in zip(stacks, local)]
        losses.append(loss)
        del grads

    def lift(parts, p):
        pl = (Shard(0),) + tuple(Shard(q.dim + 1) if isinstance(q, Shard)
                                 else q for q in p.placements[1:])
        return DTensor.from_local(torch.stack(parts), mesh, pl,
                                  run_check=False)

    with outside_fake_mode():
        stack = tree_unflatten(params, [lift(s, p) for s, p in
                                        zip(stacks, tree_leaves(params))])
    grads = _pod_sync_local_map(stack, tcfg.quant_block)
    loss = torch.stack(_gather_pods(losses, group, size)).mean()
    return grads, loss


def make_train_step(cfg: ArchConfig, opt: ModelOptions, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch, step, on_stage=None)
    -> (params, opt_state, metrics); params and opt_state are updated in
    place."""
    if tcfg.dp_compress not in DP_COMPRESS:
        raise ValueError(f"dp_compress must be one of {DP_COMPRESS}, got "
                         f"{tcfg.dp_compress!r}")
    grads_of = make_grads_fn(cfg, opt)

    def train_step(params, opt_state, batch, step, on_stage=None):
        mark = on_stage or (lambda stage: None)
        lr = cosine_schedule(step, peak_lr=tcfg.adamw.lr,
                             warmup_steps=tcfg.warmup_steps,
                             total_steps=tcfg.total_steps)
        if tcfg.dp_compress == "int8" and tcfg.num_pods > 1 and \
                is_dtensor(tree_leaves(params)[0]):
            grads, loss = _sharded_pod_grads(grads_of, params, batch, tcfg)
            mark("pod_sync")
        elif tcfg.dp_compress == "int8" and tcfg.num_pods > 1:
            group, size, rank = _pod_axis()
            if tcfg.num_pods % size:
                raise ValueError(f"{tcfg.num_pods} pods do not split over a "
                                 f"pod axis of {size}")
            per = tcfg.num_pods // size
            mine = split_pods(batch, tcfg.num_pods)[rank * per:
                                                    (rank + 1) * per]
            pods_q, losses = [], []
            for pod_batch in mine:
                grads, loss = grads_of(params, pod_batch)
                mark("forward_backward")
                pods_q.append(_quantize_pod(grads, tcfg.quant_block))
                del grads
                mark("pod_sync")
                losses.append(loss)
            grads = _dequantize_mean(pods_q, params, tcfg.quant_block,
                                     group, size)
            del pods_q
            loss = torch.stack(_gather_pods(losses, group, size)).mean()
            mark("pod_sync")
        else:
            grads, loss = grads_of(params, batch)
            mark("forward_backward")
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             tcfg.adamw, lr=lr)
        mark("optimizer")
        return params, opt_state, {"loss": loss, "lr": lr, **om}

    return train_step


def make_eval_step(cfg: ArchConfig, opt: ModelOptions):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, cfg, batch, opt)
        return {"loss": loss, **metrics}
    return eval_step
