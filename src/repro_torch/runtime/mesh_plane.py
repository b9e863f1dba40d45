"""Mesh plane: the lattice and the replicated store across ranks.

PyTorch counterpart of ``repro.runtime.mesh_plane``. Everything else in
the port runs in one process: the schemes x nets x C x policies lattice
is one `vmap` (`desim._lattice`) and `serve_replicated`'s C replicas
share one program. This module places the outermost axis of each on the
ranks of a 1-axis ``("data",)`` mesh (`launch.mesh.make_data_mesh`, a
``DeviceMesh`` over a ``torch.distributed`` process group: NCCL on the
card, gloo on the CPU):

* ``simulate_lattice_sharded`` splits the nets x policies cells, padded
  with copies of cell 0 up to a multiple of the world size, across the
  ranks. Each rank sweeps its cells through the same `_simulate_point`
  as `desim.simulate_lattice`; one `all_gather` of the metric stacks at
  the end gives every rank the whole nested result. At world 1 the
  lanes, their order and their count are `simulate_lattice`'s, so the
  results are the same bits.

* ``shard_replicated_state`` / ``step_replicated_sharded`` /
  ``serve_replicated_sharded`` place the (C,) replica axis of
  `step_fetch_replicated` on the ranks: each rank holds its replicas'
  sequence state, NIC banks and telemetry, and the SHARED memory-module
  channel bank is merged at the fabric boundary every step with
  `fabric.reduce_deltas` (base + the ranks' deltas in rank order, one
  collective per step). Byte ledgers are additive, so two-endpoint byte
  conservation stays exact; contention across ranks lands at the step
  boundary (each rank's in-step view sees only its own queueing).
  `gather_replicated_state` is the inverse of the placement: the
  reference's global arrays are, in torch, the ranks' shards gathered.

The reference's `sharded_lattice_cache_size` and
`sharded_store_cache_size` count XLA jit entries; nothing is compiled
here, so they have no counterpart (as `desim.lattice_cache_size`).
"""
from __future__ import annotations

import torch

from repro_torch.core import compute_plane, fabric
from repro_torch.core.daemon_store import (KVStoreConfig,
                                           ReplicatedKVStoreState,
                                           step_fetch_replicated)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.sim import desim

__all__ = ["simulate_lattice_sharded", "shard_replicated_state",
           "gather_replicated_state", "step_replicated_sharded",
           "serve_replicated_sharded", "make_data_mesh"]

AXIS = "data"


def _coords(mesh):
    """(this rank's index on the ``"data"`` axis, the axis' size)."""
    return mesh.get_local_rank(AXIS), mesh.size(0)


def _all_gather(x, group) -> list:
    """Every rank's `x` (one shape and dtype on all), in rank order."""
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def _gather_leaves(leaves, group) -> list:
    """Every rank's copy of each tensor in `leaves`, as one list per
    leaf in rank order: the leaves travel as the bytes of one buffer in
    one collective (any dtype, bool and bf16 included, on any backend)."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in leaves]
    parts = _all_gather(torch.cat(flat), group)
    out, off = [], 0
    for t, f in zip(leaves, flat):
        out.append([p[off:off + f.numel()].clone().view(t.dtype).reshape(
            t.shape) for p in parts])
        off += f.numel()
    return out


def gather_rows(x, mesh) -> torch.Tensor:
    """Every rank's `x` concatenated on dim 0, in rank order."""
    return torch.cat(_all_gather(x, mesh.get_group(AXIS)))


# ------------------------------------------------------------ lattice plane
def simulate_lattice_sharded(schemes, cfg, trace, nets, comp_ratio,
                             mesh=None, warm_frac: float = 0.3,
                             active_cus=None, policies=None,
                             telemetry_cfg=None, device=None):
    """`desim.simulate_lattice`, its cells split across the ranks.

    Same arguments and nested result as `desim.simulate_lattice`, plus
    `mesh`, a 1-axis ``("data",)`` mesh (default: `make_data_mesh()`
    over the whole world; with no process group that raises). Cell k of
    the nets x policies product is (net k // P, policy k % P); the cells
    are padded with copies of cell 0 up to a multiple of the world size
    (computed twice, dropped before nesting), rank r sweeps the r-th
    slice of them, and every rank returns the whole result. Runs on the
    card unless `device` says otherwise."""
    if mesh is None:
        mesh = make_data_mesh()
    dev = resolve_device(device)
    schemes = list(schemes)      # may be a generator: list ONCE
    (tflags, warm_after, arrays, stacked, cr, cus, pols, telcfg,
     squeeze_cu, squeeze_pol, n_cus, n_pols) = desim._lattice_inputs(
        schemes, cfg, trace, nets, comp_ratio, warm_frac, active_cus,
        policies, telemetry_cfg, dev)
    rank, world = _coords(mesh)
    n_schemes, n_nets = len(schemes), len(nets)
    ncells = n_nets * n_pols
    per = -(-ncells // world)
    cells = ([(k // n_pols, k % n_pols) for k in range(ncells)]
             + [(0, 0)] * (per * world - ncells))
    res = desim._lattice(cfg, trace.n_pages, telcfg, tflags, warm_after,
                         arrays, stacked, cr, cus, pols,
                         cells=cells[rank * per:(rank + 1) * per])
    keys = list(res)
    # every rank's (K, S, cells_loc, C) stack, joined on the cells
    parts = _all_gather(torch.stack([res[k] for k in keys]),
                        mesh.get_group(AXIS))
    full = torch.cat(parts, dim=2)[:, :, :ncells]
    return desim._nest_cells(dict(zip(keys, full)), n_schemes, n_nets,
                             n_cus, n_pols, squeeze_cu, squeeze_pol)


# -------------------------------------------------------------- store plane
def _split_dims(state: ReplicatedKVStoreState) -> ReplicatedKVStoreState:
    """The placement of a replicated store's leaves, as the reference's
    `_STATE_SPECS`: 0 = split on dim 0 (every sequence leaf, telemetry
    included, on its replica-major (C*B,) axis; the NIC bank's (C,)
    leaves and `link.bw`), 1 = split on dim 1 (the NIC link's (K, C)
    `sched_mult` and `health`), -1 = whole on every rank (the shared
    module bank, the NIC link's `sched_t`, the clock)."""
    nic = compute_plane.tree_map(lambda _: 0, state.nic)
    nic = nic._replace(link=nic.link._replace(sched_t=-1, sched_mult=1,
                                              health=1))
    return ReplicatedKVStoreState(
        seqs=compute_plane.tree_map(lambda _: 0, state.seqs),
        fab=compute_plane.tree_map(lambda _: -1, state.fab), nic=nic,
        clock=-1)


def shard_replicated_state(state: ReplicatedKVStoreState, mesh
                           ) -> ReplicatedKVStoreState:
    """This rank's part of a replicated store's state: replicas
    [r*C/W, (r+1)*C/W), replica-major, of every sequence leaf and of the
    NIC bank; the shared module bank and the clock whole. At world 1 the
    leaves are the state's own tensors; otherwise compact copies, so the
    global state can be dropped. C must divide evenly by the world size
    (ValueError otherwise)."""
    c = state.num_replicas
    rank, world = _coords(mesh)
    if c % world:
        raise ValueError(f"num_replicas={c} must divide evenly across "
                         f"{world} mesh devices")

    def split(dim, x):
        if dim < 0 or world == 1:
            return x
        n = x.shape[dim] // world
        return x.narrow(dim, rank * n, n).clone()

    return compute_plane.tree_map(split, _split_dims(state), state)


def gather_replicated_state(local: ReplicatedKVStoreState, mesh
                            ) -> ReplicatedKVStoreState:
    """The inverse of `shard_replicated_state`: every rank's part
    gathered into the whole (C replicas) state, on every rank, in one
    collective."""
    dims = compute_plane.tree_leaves(_split_dims(local))
    leaves = compute_plane.tree_leaves(local)
    split = [x for d, x in zip(dims, leaves) if d >= 0]
    parts = iter(_gather_leaves(split, mesh.get_group(AXIS)))
    whole = [x if d < 0 else torch.cat(next(parts), dim=d)
             for d, x in zip(dims, leaves)]
    return compute_plane.tree_unflatten(local, whole)


def step_replicated_sharded(state: ReplicatedKVStoreState,
                            cfg: KVStoreConfig, mesh, remote_k, remote_v,
                            needed_pages, needed_offsets=None,
                            needed_writes=None, policy=None):
    """`step_fetch_replicated` with the (C,) replica axis on the ranks.

    `state` is this rank's part (`shard_replicated_state`).
    `needed_pages` / offsets / writes are the GLOBAL (C, B, R) requests,
    replica-major, as the reference takes them; the rank steps its
    replicas' slice. The NIC gate is the global replica count's: a rank
    stepping one local replica of a C = 2 deployment still pays its NIC
    leg. Then the shared bank is merged across the ranks
    (`fabric.reduce_deltas`, one collective). At world 1 that is
    ``base + (local - base)``, which the reference's test bar holds
    bit-equal to `step_fetch_replicated`.

    Returns (state, k (C/W, B, R, page, KV, D), v, served_local
    (C/W, B, R)): this rank's LOCAL slices, where the reference returns
    global arrays sharded on ``"data"``."""
    rank, world = _coords(mesh)
    dev = state.clock.device
    pages = torch.as_tensor(needed_pages, device=dev)
    c = pages.shape[0]
    if c % world or state.num_replicas != c // world:
        raise ValueError(f"{c} replicas of requests over {world} ranks do "
                         f"not match a local state of "
                         f"{state.num_replicas} replicas")
    cl = c // world

    def mine(x):
        return None if x is None else torch.as_tensor(
            x, device=dev).narrow(0, rank * cl, cl)

    base = state.fab
    state, k, v, hit = step_fetch_replicated(
        state, cfg, remote_k, remote_v, mine(pages), mine(needed_offsets),
        mine(needed_writes), policy=policy, active=c > 1)
    fab = fabric.reduce_deltas(base, state.fab, mesh.get_group(AXIS))
    return state._replace(fab=fab), k, v, hit


def serve_replicated_sharded(params, cfg, prompts, scfg, store_cfg,
                             num_replicas: int, mesh=None, **kw):
    """`serve_loop.serve_replicated` with the replica axis on the ranks
    of `mesh` (default: `make_data_mesh()` over the whole world; with no
    process group that raises): same arguments, same (tokens (C, B, T),
    ledger) on every rank."""
    from repro_torch.runtime.serve_loop import serve_replicated
    if mesh is None:
        mesh = make_data_mesh()
    return serve_replicated(params, cfg, prompts, scfg, store_cfg,
                            num_replicas, mesh=mesh, **kw)
