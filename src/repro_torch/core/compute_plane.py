"""Compute plane: per-compute-unit state and NIC channel banks.

PyTorch counterpart of ``repro.core.compute_plane``: the compute axis of
the paper's scalability claim (figs 17/22), C compute units contending on
one shared memory pool. A unit owns its engines and local tables (carried
on a leading (C,) axis: `replicate`, `unit_slice`, `unit_update`) and its
NIC, a compute-side channel bank that IS a `fabric.FabricState` indexed
by unit instead of by memory module, so all channel arithmetic still goes
through `fabric.serve_dual_at` / `serve_writeback_at`.

Two-leg service: every transfer is priced on the shared module's bank
and on the requesting unit's NIC; arrival is the later completion. The
NIC leg is gated by `active`, a bool tensor (true iff more than one unit
is active), so C = 1 leaves the NIC bank's clocks and byte ledgers
untouched bit for bit and the combined times are the module leg's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.core import fabric
from repro_torch.core.fabric import FabricState, LinkModel

F32 = torch.float32
I32 = torch.int32

# Knuth multiplicative mix for request -> unit sharding, folded with a
# different shift than fabric.place's hash so unit choice decorrelates
# from module choice.
_SHARD_MULT = -1640531527
_SHARD_SHIFT = 16


@dataclass(frozen=True)
class ComputePlaneConfig:
    """Static compute-plane shape: the unit-count envelope. How many of
    the units receive traffic is data (`shard_unit`'s `active_units`,
    the two-leg service's `active`)."""
    num_units: int = 1

    def __post_init__(self):
        if self.num_units < 1:
            raise ValueError("num_units must be >= 1")

    def nic_config(self) -> fabric.FabricConfig:
        """The NIC bank's fabric shape: one 'module' per compute unit."""
        return fabric.FabricConfig(num_modules=self.num_units)


# ------------------------------------------------------- per-unit trees
def tree_map(fn, tree, *rest):
    """Map `fn` over the leaves (tensors or arrays) of nested NamedTuples,
    tuples, lists and dicts (None stays None), zipping `rest` trees
    alongside."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of `tree` in `tree_map`'s visiting order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like `like` whose leaves are `leaves`, taken in
    `tree_map`'s visiting order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def replicate(tree, num_units: int):
    """Stack a per-unit state tree C times along a new leading axis."""
    return tree_map(lambda x: torch.stack([x] * num_units), tree)


def unit_slice(tree, cu):
    """One unit's slice of a (C, ...)-leading tree; `cu` an int or a 0-d
    index tensor (read on the device, no host sync). With one unit the
    slice is a view: `cu` can only be 0."""
    def take(a):
        if a.shape[0] == 1:
            return a[0]
        return a.index_select(
            0, torch.as_tensor(cu, device=a.device).reshape(1).long())[0]
    return tree_map(take, tree)


def unit_update(tree, cu, new):
    """Scatter one unit's updated slice back into the (C, ...) tree
    (out of place; with one unit, the slice itself)."""
    def put(a, n):
        n = n.to(a.dtype).unsqueeze(0)
        if a.shape[0] == 1:
            return n
        idx = torch.as_tensor(cu, device=a.device).reshape(1).long()
        return a.index_copy(0, idx, n)
    return tree_map(put, tree, new)


# ------------------------------------------------------------- sharding
def shard_unit(page_id, active_units) -> torch.Tensor:
    """Request -> compute unit, int32 in [0, active_units): the page id's
    Knuth mix (int32 product with two's-complement wraparound, taken here
    in int64 and cut to its low 31 bits, which are the same bits) folded
    by `_SHARD_SHIFT`."""
    page_id = torch.as_tensor(page_id).to(I32)
    mixed = (page_id.long() * _SHARD_MULT) & 0x7FFFFFFF
    units = torch.as_tensor(active_units, device=page_id.device).long()
    return ((mixed >> _SHARD_SHIFT) % units).to(I32)


# ------------------------------------------------------------- NIC banks
def mean_last(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis as XLA:CPU computes `jnp.mean`: an f32 sum
    in index order, times the f32 reciprocal of the count. The same
    value on every device (the reference's rounding, reproduced on
    purpose)."""
    n = x.shape[-1]
    total = torch.zeros(x.shape[:-1], dtype=F32, device=x.device)
    for i in range(n):
        total = total + x[..., i].to(F32)
    # a Python float operand is rounded to f32 and multiplied in f32 on
    # both devices, with no copy from the host
    return total * (1.0 / n)


def nic_link_for(mem_link: LinkModel, num_units: int) -> LinkModel:
    """Per-unit NIC link derived from the memory-side LinkModel: every
    unit serializes at the network's mean per-module bandwidth and
    breathes with the module-averaged schedule; health stays 1 (module
    link failures are module-side events)."""
    dev = mem_link.bw.device
    k = mem_link.sched_t.shape[0]
    m_bw = mean_last(mem_link.bw)
    mult = mean_last(mem_link.sched_mult)[:, None]
    return LinkModel(
        bw=m_bw.expand(num_units).contiguous(),
        sched_t=mem_link.sched_t,
        sched_mult=mult.expand(k, num_units).contiguous(),
        health=torch.ones((k, num_units), dtype=F32, device=dev))


def init_nic_bank(num_units: int, link: LinkModel = None, ratio=0.25,
                  device=None) -> FabricState:
    """Fresh per-unit NIC channel bank (a FabricState indexed by unit)."""
    cfg = fabric.FabricConfig(num_modules=num_units)
    if link is None:
        link = fabric.constant_link(1.0, num_units, device=device)
    return fabric.init_fabric(cfg, link=link, ratio=ratio,
                              device=link.bw.device)


# ---------------------------------------------------------- two-leg service
def serve_dual_two_leg(mem: FabricState, nic: FabricState, mc, cu, *,
                       partition, now, line_ready, line_bytes,
                       line_gate, page_ready, page_bytes, page_gate,
                       active) -> Tuple[FabricState, FabricState,
                                        torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """One dual-granularity service step on module `mc`'s bank and on
    unit `cu`'s NIC (same ready times and bytes); the NIC leg's gates
    are ANDed with `active`. Returns (mem', nic', line_done, page_done,
    line_done_mod, page_done_mod): the combined completions (the later
    leg when active) and the module leg's. `partition` is a Python bool
    or a bool tensor (`bandwidth.shares`)."""
    active = torch.as_tensor(active, dtype=torch.bool,
                             device=mem.line_busy.device)
    mem, l_mod, p_mod = fabric.serve_dual_at(
        mem, mc, partition=partition, now=now,
        line_ready=line_ready, line_bytes=line_bytes, line_gate=line_gate,
        page_ready=page_ready, page_bytes=page_bytes, page_gate=page_gate)
    nic, l_nic, p_nic = fabric.serve_dual_at(
        nic, cu, partition=partition, now=now,
        line_ready=line_ready, line_bytes=line_bytes,
        line_gate=line_gate & active,
        page_ready=page_ready, page_bytes=page_bytes,
        page_gate=page_gate & active)
    line_done = torch.where(active, torch.maximum(l_mod, l_nic), l_mod)
    page_done = torch.where(active, torch.maximum(p_mod, p_nic), p_mod)
    return mem, nic, line_done, page_done, l_mod, p_mod


def serve_writeback_two_leg(mem: FabricState, nic: FabricState, mc, cu,
                            t_ready, nbytes, *, gate, active, now=None
                            ) -> Tuple[FabricState, FabricState,
                                       torch.Tensor]:
    """Eviction writeback on the module's reverse channel AND the
    evicting unit's NIC writeback channel (later completion wins); the
    NIC leg is gated like `serve_dual_two_leg`."""
    active = torch.as_tensor(active, dtype=torch.bool,
                             device=mem.wb_busy.device)
    mem, done_mod = fabric.serve_writeback_at(mem, mc, t_ready, nbytes,
                                              gate=gate, now=now)
    nic, done_nic = fabric.serve_writeback_at(nic, cu, t_ready, nbytes,
                                              gate=gate & active, now=now)
    done = torch.where(active, torch.maximum(done_mod, done_nic), done_mod)
    return mem, nic, done


def unit_bytes(nic: FabricState) -> torch.Tensor:
    """(C,) total wire bytes each unit's NIC carried (all channels)."""
    return nic.line_bytes + nic.page_bytes + nic.wb_bytes
