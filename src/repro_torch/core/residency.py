"""Residency plane: the local-memory page table and its replacement policies.

PyTorch counterpart of ``repro.core.residency``. A ``ResidencyState`` is a
set-associative page table (``sets x ways``; fully associative is one set
of N ways) carrying, per slot, the resident page id, a policy age clock, a
``ready`` time (the in-flight tag), a dirty bit and an RRIP re-reference
prediction value.

Every leaf carries an explicit leading batch axis: ``(B, S, W)``. The JAX
package writes the primitives for one table and ``vmap``s them; here each
primitive takes the batch directly, and the per-request arguments are
``(B, R)``. Policies are traced data (``PolicyFlags`` of 0-d tensors), so
one code path serves LRU, FIFO, RRIP and dirty-averse by ``torch.where``.

The arithmetic is the reference's, op for op, so that page ids, metadata
and victim order agree exactly:

* duplicate-index max/min scatters (``touch``, ``mark_dirty``) are
  ``scatter_reduce(..., include_self=True)`` on flat ``set * W + way``
  indices;
* ``insert``'s ``mode="drop"`` scatter becomes masked lanes routed to a
  scratch column that is cut off afterwards;
* the stable victim argsort is ``torch.sort(stable=True)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

F32 = torch.float32
I32 = torch.int32
BIG = 3.0e38

RRPV_MAX = 3.0      # empty slots: evict-first
RRPV_INSERT = 2.0   # "long re-reference" insertion prediction
RRPV_HIT = 0.0      # re-referenced: protect


# ---------------------------------------------------------------- policies
@dataclass(frozen=True)
class PolicySpec:
    """Registry entry (static Python) — the human-facing policy handle."""
    name: str
    touch_refresh: bool = True     # refresh age on hit (LRU); FIFO: False
    dirty_penalty: float = 0.0     # >0: dirty slots outlive clean ones
    rrip: bool = False             # RRPV-scored victim selection


class PolicyFlags(NamedTuple):
    """PolicySpec as 0-d tensor leaves (`name` dropped)."""
    touch_refresh: torch.Tensor    # bool
    dirty_penalty: torch.Tensor    # f32
    rrip: torch.Tensor             # bool


POLICIES = {
    "lru": PolicySpec("lru"),
    "fifo": PolicySpec("fifo", touch_refresh=False),
    "rrip": PolicySpec("rrip", rrip=True),
    "dirty-averse": PolicySpec("dirty-averse", dirty_penalty=1.0),
}


def as_policy(pol, device=None) -> PolicyFlags:
    """PolicySpec, name or PolicyFlags -> PolicyFlags on `device`."""
    if isinstance(pol, PolicyFlags):
        if device is None:
            return pol
        return PolicyFlags(*(t.to(device) for t in pol))
    if isinstance(pol, str):
        pol = POLICIES[pol]
    return PolicyFlags(
        touch_refresh=torch.tensor(pol.touch_refresh, dtype=torch.bool,
                                   device=device),
        dirty_penalty=torch.tensor(pol.dirty_penalty, dtype=F32,
                                   device=device),
        rrip=torch.tensor(pol.rrip, dtype=torch.bool, device=device))


# ------------------------------------------------------------------- state
class ResidencyState(NamedTuple):
    """Batched set-associative page table. All leaves (B, S, W)."""
    page: torch.Tensor    # int32 — resident/inserted page id, -1 empty
    age: torch.Tensor     # f32   — policy clock (insert / touch time)
    ready: torch.Tensor   # f32   — arrival time (in-flight tag); BIG empty
    dirty: torch.Tensor   # bool  — locally-written resident page
    rrpv: torch.Tensor    # f32   — re-reference prediction value


def init_residency(sets: int, ways: int, device=None) -> ResidencyState:
    """One empty (S, W) table; `compute_plane.replicate` stacks the
    batch axis the primitives below take."""
    shape = (sets, ways)
    return ResidencyState(
        page=torch.full(shape, -1, dtype=I32, device=device),
        age=torch.zeros(shape, dtype=F32, device=device),
        ready=torch.full(shape, BIG, dtype=F32, device=device),
        dirty=torch.zeros(shape, dtype=torch.bool, device=device),
        rrpv=torch.full(shape, RRPV_MAX, dtype=F32, device=device),
    )


def num_sets(res: ResidencyState) -> int:
    return res.page.shape[-2]


def _flat(t: torch.Tensor) -> torch.Tensor:
    """(B, S, W) -> (B, S*W) flat slot view."""
    return t.reshape(t.shape[0], -1)


def _slots(res: ResidencyState, set_idx, way) -> torch.Tensor:
    return (set_idx * res.page.shape[-1] + way).long()


# ------------------------------------------------------------------ lookup
def set_index(res: ResidencyState, page) -> torch.Tensor:
    """page id -> set (low-order index bits; S=1 maps everything to 0)."""
    return page.to(I32) % num_sets(res)


def lookup(res: ResidencyState, pages, now
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe (B, R) page ids -> (present, set_idx, way, ready_ok), each
    (B, R). A miss reports way 0 (the first maximum of an all-False row)."""
    pages = pages.to(I32)
    b, r = pages.shape
    w = res.page.shape[-1]
    set_idx = set_index(res, pages)
    rows = res.page.gather(1, set_idx.long()[..., None].expand(b, r, w))
    hit_vec = rows == pages[..., None]
    present = hit_vec.any(dim=-1)
    way = hit_vec.to(I32).argmax(dim=-1).to(I32)
    ready_ok = _flat(res.ready).gather(1, _slots(res, set_idx, way)) <= now
    return present, set_idx, way, ready_ok


# ----------------------------------------------------------------- mutation
def touch(res: ResidencyState, set_idx, way, now, pol: PolicyFlags, *,
          gate) -> ResidencyState:
    """Hit-time policy refresh at (set_idx, way), each (B, R): the age
    takes max(age, now) where gated and the policy refreshes, the RRPV
    min(rrpv, 0) where gated. Max/min scatters make duplicate lanes and
    un-gated lanes no-ops."""
    shape = res.age.shape
    idx = _slots(res, set_idx, way)
    do = gate.to(torch.bool)
    now = now.to(F32)
    age_val = torch.where(do & pol.touch_refresh, now,
                          torch.zeros((), dtype=F32, device=now.device))
    rr_val = torch.where(do, torch.full_like(age_val, RRPV_HIT),
                         torch.full_like(age_val, RRPV_MAX))
    age = _flat(res.age).scatter_reduce(1, idx, age_val, "amax",
                                        include_self=True)
    rrpv = _flat(res.rrpv).scatter_reduce(1, idx, rr_val, "amin",
                                          include_self=True)
    return res._replace(age=age.reshape(shape), rrpv=rrpv.reshape(shape))


def mark_dirty(res: ResidencyState, set_idx, way, write, *,
               gate) -> ResidencyState:
    """OR a (B, R) write flag into the dirty bit at (set_idx, way)."""
    shape = res.dirty.shape
    val = (gate.to(torch.bool) & write.to(torch.bool)).to(torch.uint8)
    dirty = _flat(res.dirty).to(torch.uint8).scatter_reduce(
        1, _slots(res, set_idx, way), val, "amax", include_self=True)
    return res._replace(dirty=dirty.reshape(shape).to(torch.bool))


def insert(res: ResidencyState, set_idx, way, page, *, now, ready, dirty,
           gate) -> ResidencyState:
    """Fill the victim slots (set_idx, way), each (B, k), with `page`.

    The GATED lanes of a row must target distinct slots (`landing_victims`
    outputs qualify). Gated-off lanes write to a scratch column past the
    table that is cut off afterwards, so a masked lane can never clobber a
    live one. Age is the insert time, `ready` the arrival time and the
    RRPV the long-re-reference insertion prediction."""
    b, s, w = res.page.shape
    n = s * w
    gate = gate.to(torch.bool)
    idx = torch.where(gate, _slots(res, set_idx, way),
                      torch.full_like(set_idx, n, dtype=torch.long))

    def put(tbl, val):
        val = (val.to(tbl.dtype) if isinstance(val, torch.Tensor) else
               torch.full((), val, dtype=tbl.dtype, device=tbl.device))
        wide = torch.cat([_flat(tbl), tbl.new_zeros((b, 1))], dim=1)
        wide = wide.scatter(1, idx, val.expand(idx.shape).contiguous())
        return wide[:, :n].reshape(b, s, w)

    return ResidencyState(
        page=put(res.page, page.to(I32)),
        age=put(res.age, now),
        ready=put(res.ready, ready),
        dirty=put(res.dirty, dirty),
        rrpv=put(res.rrpv, RRPV_INSERT),
    )


# ---------------------------------------------------------- victim scoring
def _score(age, dirty, rrpv, pol: PolicyFlags) -> torch.Tensor:
    """Per-slot eviction score over the last (ways) axis, lower evicted
    first — `repro.core.residency._score`, op for op:

      time policies: score = age + dirty * dirty_penalty * span
      rrip:          score = (RRPV_MAX - rrpv) * span + (age - min_age)

    with span = the set's age spread + 1."""
    amin = age.amin(dim=-1, keepdim=True)
    span = (age.amax(dim=-1, keepdim=True) - amin) + 1.0
    zero = torch.zeros((), dtype=F32, device=age.device)
    base = age + torch.where(dirty, pol.dirty_penalty * span, zero)
    rr = (RRPV_MAX - rrpv) * span + (age - amin)
    return torch.where(pol.rrip, rr, base)


def evict_order_sets(res: ResidencyState, pol: PolicyFlags) -> torch.Tensor:
    """Every set's ways in eviction order: (B, S, W) int64, row (b, s)
    listing the ways of set s first-evicted-first (stable on ties)."""
    score = _score(res.age, res.dirty, res.rrpv, pol)
    return torch.sort(score, dim=-1, stable=True).indices


def landing_victims(res: ResidencyState, pids, pol: PolicyFlags
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Victim slots for a multi-page landing: lane j of `pids` (B, k)
    takes the rank-j victim of its own set, rank = the number of earlier
    lanes in the same set. Returns (sets, ways, ok), each (B, k); `ok` is
    False for lanes whose set already absorbed W landings this step."""
    w = res.page.shape[-1]
    sets = set_index(res, torch.clamp(pids.to(I32), min=0))
    k = sets.shape[1]
    lane = torch.arange(k, device=sets.device)
    rank = ((sets[:, None, :] == sets[:, :, None])
            & (lane[None, :] < lane[:, None])).sum(dim=-1)
    ok = rank < w
    order = evict_order_sets(res, pol)                     # (B, S, W)
    rows = order.gather(1, sets.long()[..., None].expand(-1, -1, w))
    ways = rows.gather(2, torch.clamp(rank, max=w - 1)[..., None])[..., 0]
    return sets, ways.to(I32), ok
