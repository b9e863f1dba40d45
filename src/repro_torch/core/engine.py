"""DaeMon engines as functional state machines (paper §4).

PyTorch counterpart of ``repro.core.engine``. The inflight page buffer
and the inflight sub-block buffer are fixed-size integer tensors with
vectorised membership tests in place of the hardware's CAMs.

State encoding (per sequence):
  inflight page buffer : keys (P,) int32 page ids (-1 empty),
                         state (P,) int8 {0 invalid,1 scheduled,2 moved,
                                          3 throttled}, arrival (P,) f32,
                         issue (P,) f32, dirty_cnt (P,) int8 (§4.3)
  inflight sub-block buffer: keys (S,) int32 packed
                         (page * lines_per_page + off), arrival (S,) f32

`poll_arrivals` and `retire_arrivals` are elementwise and take any
leading batch axes. The per-request transitions (`select_granularity`,
`schedule_page`, `schedule_line`) take one sequence's (P,)/(S,) buffers
and 0-d tensor scalars; the store calls them inside its scheduling loop.
Indices stay tensors (`_at`/`_put`), so no transition reads a value back
to the host. The §4.3 dirty unit (`note_dirty_eviction` in the
reference) runs vectorised over a step's evictions in
`daemon_store._writebacks`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.params import DaemonParams

INVALID, SCHEDULED, MOVED, THROTTLED = 0, 1, 2, 3
F32 = torch.float32
I32 = torch.int32
I8 = torch.int8
NEVER = 3.4e38


class EngineState(NamedTuple):
    page_key: torch.Tensor      # (..., P) int32
    page_state: torch.Tensor    # (..., P) int8
    page_arrival: torch.Tensor  # (..., P) f32 — expected arrival time
    page_issue: torch.Tensor    # (..., P) f32 — leaves the page queue
    page_dirty: torch.Tensor    # (..., P) int8 — dirty lines buffered
    sb_key: torch.Tensor        # (..., S) int32, -1 empty
    sb_arrival: torch.Tensor    # (..., S) f32


def init_engine_state(p: DaemonParams, device=None) -> EngineState:
    pb, sb = (p.inflight_page_buf,), (p.inflight_sb_buf,)
    return EngineState(
        page_key=torch.full(pb, -1, dtype=I32, device=device),
        page_state=torch.zeros(pb, dtype=I8, device=device),
        page_arrival=torch.full(pb, NEVER, dtype=F32, device=device),
        page_issue=torch.full(pb, NEVER, dtype=F32, device=device),
        page_dirty=torch.zeros(pb, dtype=I8, device=device),
        sb_key=torch.full(sb, -1, dtype=I32, device=device),
        sb_arrival=torch.full(sb, NEVER, dtype=F32, device=device),
    )


def pack_line(page_id, offset, lines_per_page: int = 64):
    """Pack (page, line-offset) into one sub-block CAM key."""
    return page_id * lines_per_page + offset


# ------------------------------------------------------- tensor indexing
def _at(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vec[idx] for a 0-d index tensor, as a 0-d tensor (no host read)."""
    return vec.gather(0, idx.reshape(1).long()).reshape(())


def _const(val, like: torch.Tensor) -> torch.Tensor:
    """`val` as a 0-d tensor of `like`'s dtype and device; a Python
    scalar is filled on the device, never copied from the host."""
    if isinstance(val, torch.Tensor):
        return val.to(like.dtype)
    return torch.full((), val, dtype=like.dtype, device=like.device)


def _put(vec: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """Out-of-place vec.at[idx].set(val) for a 0-d index tensor."""
    return vec.scatter(0, idx.reshape(1).long(), _const(val, vec).reshape(1))


# ---------------------------------------------------------------- lookups
def find(keys, key) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found: bool, idx: int64), both 0-d. Vectorised CAM lookup."""
    hit = keys == key
    return hit.any(), hit.to(I32).argmax()


def utilization(keys) -> torch.Tensor:
    return (keys >= 0).to(F32).mean()


def first_free(keys) -> Tuple[torch.Tensor, torch.Tensor]:
    free = keys < 0
    return free.any(), free.to(I32).argmax()


def gate_tree(gate, old, new):
    """where(gate, new, old) over a NamedTuple of tensors."""
    return type(old)(*(torch.where(gate, b, a) for a, b in zip(old, new)))


# ------------------------------------------------------------- selection
def select_granularity(st: EngineState, page_id, now, *,
                       selection_enabled, always_both,
                       module_pressure=0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """§4.2 selection granularity unit -> (send_line, send_page) bools.

    * page not scheduled  -> always send the line; schedule the page too
      if the inflight page buffer has room.
    * page already inflight -> send the line only if the sub-block buffer
      is less utilised than the page buffer (plus the target module's
      normalised page backlog, `module_pressure`) AND the page has not
      been issued yet at `now`.
    * always_both bypasses the selection (still dedups inflight pages and
      full buffers).

    The two mode flags are Python bools (the store's static config: the
    branch is taken on the host) or bool tensors (the simulator's scheme
    axis: both are `torch.where`-selected, as in the reference).
    """
    page_found, pidx = find(st.page_key, page_id)
    page_room, _ = first_free(st.page_key)
    sb_room, _ = first_free(st.sb_key)
    page_util = utilization(st.page_key)
    sb_util = utilization(st.sb_key)
    send_page = ~page_found & page_room
    page_issued = page_found & (_at(st.page_issue, pidx) <= now)
    line_if_inflight = (sb_util < page_util + module_pressure) & ~page_issued
    selected = torch.where(page_found, line_if_inflight, True)
    if isinstance(always_both, bool) and isinstance(selection_enabled,
                                                    bool):
        if always_both:
            send_line = torch.ones_like(selected)
        elif selection_enabled:
            send_line = selected
        else:
            send_line = ~page_found
    else:
        send_line = torch.where(always_both, torch.ones_like(selected),
                                torch.where(selection_enabled, selected,
                                            ~page_found))
    return send_line & sb_room, send_page


# ------------------------------------------------------------ scheduling
def schedule_page(st: EngineState, page_id, issue_t, arrival_t
                  ) -> EngineState:
    ok, idx = first_free(st.page_key)
    idx = torch.where(ok, idx, 0)

    def put(arr, val):
        return _put(arr, idx, torch.where(ok, _const(val, arr),
                                          _at(arr, idx)))

    return st._replace(
        page_key=put(st.page_key, page_id),
        page_state=put(st.page_state, SCHEDULED),
        page_arrival=put(st.page_arrival, arrival_t),
        page_issue=put(st.page_issue, issue_t),
        page_dirty=put(st.page_dirty, 0),
    )


def schedule_line(st: EngineState, page_id, offset, arrival_t,
                  lines_per_page: int = 64) -> EngineState:
    key = pack_line(page_id, offset, lines_per_page)
    ok, idx = first_free(st.sb_key)
    idx = torch.where(ok, idx, 0)
    return st._replace(
        sb_key=_put(st.sb_key, idx,
                    torch.where(ok, key.to(I32), _at(st.sb_key, idx))),
        sb_arrival=_put(st.sb_arrival, idx,
                        torch.where(ok, arrival_t,
                                    _at(st.sb_arrival, idx))),
    )


# --------------------------------------------------------------- arrivals
def poll_arrivals(st: EngineState, now) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask, keys) of inflight pages whose data has arrived by `now`.
    Throttled pages (§4.3) are excluded — they are re-requested."""
    done = (st.page_arrival <= now) & (st.page_state == SCHEDULED)
    return done, torch.where(done, st.page_key, -1)


def retire_arrivals(st: EngineState, now,
                    lines_per_page: int = 64) -> EngineState:
    """Release every entry whose data has arrived by `now`; a page
    arrival also drops pending sub-block entries of the same page (§4.1).
    """
    page_done, arrived_pages = poll_arrivals(st, now)
    sb_page = torch.div(st.sb_key, lines_per_page, rounding_mode="floor")
    sb_drop = (sb_page[..., :, None]
               == arrived_pages[..., None, :]).any(dim=-1)
    sb_done = (st.sb_arrival <= now) | sb_drop
    never = torch.full((), NEVER, dtype=F32, device=now.device)
    return st._replace(
        page_key=torch.where(page_done, -1, st.page_key),
        page_state=torch.where(page_done, INVALID, st.page_state).to(I8),
        page_arrival=torch.where(page_done, never, st.page_arrival),
        page_issue=torch.where(page_done, never, st.page_issue),
        page_dirty=torch.where(page_done, 0, st.page_dirty).to(I8),
        sb_key=torch.where(sb_done, -1, st.sb_key),
        sb_arrival=torch.where(sb_done, never, st.sb_arrival),
    )
