"""DaemonKVStore: two-tier paged KV cache with DaeMon movement policies.

PyTorch counterpart of ``repro.core.daemon_store``, batched path. B
tenant sequences, each with its own local page pool, page table
(``residency``) and movement engine (``engine``), contend for ONE
movement fabric (``fabric``). Per decode step, `step_fetch_batch`:

  1. runs the fused residency transaction for the whole batch
     (`_transact` -> ``ops.residency_fused``: landing, victim choice,
     dirty-eviction list, pool scatter, CAM probe, hit gather, touch) —
     one CUDA kernel launch on the card;
  2. serves misses through the sub-block plane from the remote tier
     (`_remote_fetch` -> ``ops.paged_gather_pair``, hit rows masked off);
  3. schedules the misses' transfers on the shared fabric (`_schedule`):
     §4.2 granularity selection, §4.1 partitioned channels, and the §4.3
     writeback path for dirty evictions.

State is NamedTuples of tensors with a leading batch axis; the fabric is
shared. The pools are updated in place by the transaction. No step reads
a value back to the host: the reference's `lax.cond`s, which only skip
work, become masks, and the scheduling loop is tensor ops.

`_schedule` keeps the reference's order. The writeback half touches
only the engines' dirty counters and the fabric's writeback channels,
which the request half never reads, so it runs first for the whole batch,
vectorised over lanes; the request half then folds over the batch in
sequence order and over each sequence's requests, with the shared fabric
as carry. Writeback busy clocks are summed as n * service time rather
than n sequential additions (equal to within float rounding).

`step_fetch` (single sequence), `step_fetch_replicated`, the
`kernel_impl="chain"` comparator and the telemetry-on levels are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import compute_plane, fabric, residency, telemetry
from repro_torch.core.engine import (EngineState, THROTTLED,
                                     _at, find, gate_tree,
                                     init_engine_state, poll_arrivals,
                                     retire_arrivals, schedule_line,
                                     schedule_page, select_granularity,
                                     utilization)
from repro_torch.core.fabric import FabricConfig, FabricState, LinkModel
from repro_torch.core.params import DaemonParams
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

F32 = torch.float32
I32 = torch.int32
BIG = 3.0e38

# hot-path implementations: "auto" = the CUDA kernels on CUDA tensors,
# their plain versions on CPU tensors; "cuda"/"ref" force one side
KERNEL_IMPLS = ops.IMPLS


@dataclass(frozen=True)
class KVStoreConfig:
    num_local_pages: int          # local pool slots (per sequence)
    page_tokens: int              # tokens per page
    kv_heads: int
    head_dim: int
    daemon: DaemonParams = DaemonParams()
    compress_pages: bool = True   # int8 link compression on page moves
    page_budget_per_step: int = 4  # page-plane raw tokens drained per step
    selection: bool = True        # §4.2 adaptive granularity (else both)
    adaptive_ratio: bool = False  # §4.1 ratio as adapted fabric state
    fabric: FabricConfig = FabricConfig()  # modules + placement
    policy: str = "lru"           # pool replacement (residency.POLICIES)
    pool_ways: int = 0            # set-assoc pool geometry; 0 = fully assoc
    kernel_impl: str = "auto"     # hot-path impl: auto|cuda|ref
    telemetry: telemetry.TelemetryConfig = telemetry.TelemetryConfig(
        lat_lo=0.01, lat_hi=1e4)

    def __post_init__(self):
        if self.policy not in residency.POLICIES:
            raise ValueError(f"policy must be one of "
                             f"{tuple(residency.POLICIES)}, "
                             f"got {self.policy!r}")
        if self.kernel_impl not in KERNEL_IMPLS:
            raise ValueError(f"kernel_impl must be one of {KERNEL_IMPLS},"
                             f" got {self.kernel_impl!r}")
        if self.pool_ways > 0 and self.num_local_pages % self.pool_ways:
            raise ValueError(f"pool_ways={self.pool_ways} must divide "
                             f"num_local_pages={self.num_local_pages}")

    def pool_geometry(self) -> Tuple[int, int]:
        """(sets, ways) of the local page table: one fully associative
        set by default (pool_ways = 0), else N/ways sets."""
        if self.pool_ways <= 0:
            return 1, self.num_local_pages
        return self.num_local_pages // self.pool_ways, self.pool_ways


class SeqState(NamedTuple):
    """Per-sequence tier state; in a batched store every leaf carries a
    leading (B,) axis. The fabric is not in here: it is shared."""
    kpool: torch.Tensor           # (N, page, KV, D) bf16
    vpool: torch.Tensor
    res: residency.ResidencyState  # (S, W) page table, slot = s * W + w
    eng: EngineState
    stats: dict
    tel: None = None              # telemetry off: no instrument state


class BatchedKVStoreState(NamedTuple):
    seqs: SeqState                # leaves have a leading (B,) axis
    fab: FabricState              # ONE bank shared by the whole batch
    clock: torch.Tensor           # 0-d f32 decode-step counter

    @property
    def stats(self) -> dict:
        return self.seqs.stats


STAT_KEYS = ("sub_block_fetches", "page_moves", "wire_bytes",
             "uncompressed_bytes", "local_hits", "requests", "stall_steps",
             "writeback_bytes", "dirty_evicts", "evictions")

SERIES_CHANNELS = ("page_backlog_steps", "ratio", "hit_rate", "evictions",
                   "writeback_bytes", "health")


def _init_seq(cfg: KVStoreConfig, device) -> SeqState:
    shape = (cfg.num_local_pages, cfg.page_tokens, cfg.kv_heads,
             cfg.head_dim)
    return SeqState(
        kpool=torch.zeros(shape, dtype=torch.bfloat16, device=device),
        vpool=torch.zeros(shape, dtype=torch.bfloat16, device=device),
        res=residency.init_residency(*cfg.pool_geometry(), device=device),
        eng=init_engine_state(cfg.daemon, device=device),
        stats={k: torch.zeros((), dtype=F32, device=device)
               for k in STAT_KEYS},
        tel=telemetry.init_state(cfg.telemetry, len(SERIES_CHANNELS)),
    )


def default_link(cfg: KVStoreConfig, device=None) -> LinkModel:
    """Constant, fully healthy per-module link at the store's nominal
    bandwidth (`link_bytes_per_step`)."""
    return fabric.constant_link(link_bytes_per_step(cfg),
                                cfg.fabric.num_modules, device=device)


def _init_fab(cfg: KVStoreConfig, link: LinkModel = None,
              device=None) -> FabricState:
    return fabric.init_fabric(cfg.fabric,
                              link=default_link(cfg, device) if link is None
                              else link,
                              ratio=cfg.daemon.bw_ratio, device=device)


def init_kv_store_batch(cfg: KVStoreConfig, batch: int,
                        link: LinkModel = None,
                        device=None) -> BatchedKVStoreState:
    """B fresh sequences against one fabric, on the card unless `device`
    says otherwise. `link` (optional) is a time-varying LinkModel whose
    knot times are decode steps."""
    device = resolve_device(device)
    seqs = compute_plane.replicate(_init_seq(cfg, device), batch)
    return BatchedKVStoreState(seqs=seqs, fab=_init_fab(cfg, link, device),
                               clock=torch.zeros((), dtype=F32,
                                                 device=device))


def _token_bytes(cfg: KVStoreConfig) -> float:
    return float(cfg.kv_heads * cfg.head_dim * 2 * 2)  # k+v bf16


def _wire_bytes(cfg: KVStoreConfig, tokens: int, compressed: bool) -> float:
    raw = tokens * _token_bytes(cfg)
    if not compressed:
        return float(raw)
    # int8 payload + one f32 scale per 256-block
    return float(raw / 2 + raw / 2 / 256 * 4)


def link_bytes_per_step(cfg: KVStoreConfig) -> float:
    """Per-module link bandwidth in bytes per decode step, sized so the
    page channel's (1 - bw_ratio) share drains `page_budget_per_step`
    raw tokens per step."""
    r = cfg.daemon.bw_ratio
    return cfg.page_budget_per_step * _token_bytes(cfg) / (1.0 - r)


def page_cost_steps(cfg: KVStoreConfig) -> int:
    """Nominal uncongested, uncompressed page service time in steps."""
    return max(1, round(cfg.page_tokens / cfg.page_budget_per_step))


# ------------------------------------------------------- the transaction
def _transact(seqs: SeqState, cfg: KVStoreConfig, remote_k, remote_v,
              clock, pol: residency.PolicyFlags, needed_pages,
              needed_writes):
    """The fused residency transaction for the B stacked sequences: one
    `ops.residency_fused` call (one kernel launch on the card). The
    engine poll/retire and the eviction count stay outside: they are
    movement-plane state. Returns (seqs', evicted (B, k), k_local,
    v_local, local_hit)."""
    landed, landed_pages = poll_arrivals(seqs.eng, clock)
    res, kpool, vpool, evicted, n_ev, k_local, v_local, local_hit = \
        ops.residency_fused(seqs.res, seqs.kpool, seqs.vpool, remote_k,
                            remote_v, landed, landed_pages, needed_pages,
                            needed_writes, clock, pol,
                            impl=cfg.kernel_impl)
    stats = {**seqs.stats,
             "evictions": seqs.stats["evictions"] + n_ev}
    eng = retire_arrivals(seqs.eng, clock, cfg.daemon.lines_per_page)
    seqs = seqs._replace(res=res, kpool=kpool, vpool=vpool, eng=eng,
                         stats=stats)
    return seqs, evicted, k_local, v_local, local_hit


def _remote_fetch(remote_k, remote_v, pages_flat, miss, impl: str):
    """Sub-block critical fetch from the remote tier. Rows that hit
    locally are masked: they skip their read and come back as zeros,
    where the reference skips the whole gather on all-hit steps. K and V
    share the index list and the mask: one launch on the card."""
    return ops.paged_gather_pair(remote_k, remote_v, pages_flat, miss,
                                 impl=impl)


# ---------------------------------------------------------- scheduling
def _writebacks(eng: EngineState, fab: FabricState, cfg: KVStoreConfig,
                evicted, clock, page_wire: float
                ) -> Tuple[EngineState, FabricState, torch.Tensor]:
    """The §4.3 dirty-eviction path for the whole batch: each evicted
    page (B, k) (-1 padded), in lane order, is offered to its sequence's
    dirty unit (the reference's `engine.note_dirty_eviction`: buffered
    while its page is inflight and under the threshold, throttling past
    it) and, when not buffered, serialized on its module's writeback
    channel.

    Vectorised over lanes with the reference's sequential semantics: an
    inflight entry's dirty counter counts the found lanes since its last
    reset, modulo threshold + 1 (a lane that reaches threshold + 1
    throttles the entry and resets the counter); a valid lane whose page
    is not inflight resets entry 0's counter, as the reference's argmax
    of an all-False match does. Returns (eng', fab', n_wb (B,) int)."""
    dp = cfg.daemon
    b, k = evicted.shape
    p = eng.page_key.shape[1]
    dev = evicted.device
    valid = evicted >= 0
    match = eng.page_key[:, None, :] == evicted[:, :, None]   # (B, k, P)
    found = valid & match.any(dim=-1)
    entry = torch.where(found, match.to(I32).argmax(dim=-1), 0)
    reset = valid & ~found                                    # entry 0
    lane = torch.arange(k, device=dev)
    before = lane[None, :] <= lane[:, None]                   # i <= j
    strictly = lane[None, :] < lane[:, None]                  # i < j
    last_reset = torch.where(reset[:, None, :] & strictly[None],
                             lane[None, None, :], -1).amax(dim=-1)
    since = (lane[None, None, :] > last_reset[:, :, None]) | (
        entry[:, :, None] != 0)                               # (B, j, i)
    same = (found[:, None, :] & (entry[:, None, :] == entry[:, :, None])
            & before[None] & since)
    count = same.sum(dim=-1)                                  # i_j
    pd0 = eng.page_dirty.to(I32).gather(1, entry)
    base = torch.where((entry == 0) & (last_reset >= 0), 0, pd0)
    cnt = torch.remainder(base + count, dp.dirty_flush_threshold + 1)
    buffered = found & (cnt != 0)
    wb = valid & ~buffered

    # final counter per entry: the value left by the last lane touching it
    touched = found | reset
    last = torch.full((b, p), -1, dtype=torch.long, device=dev)
    last = last.scatter_reduce(1, entry, torch.where(touched, lane, -1)
                               .expand(b, k), "amax", include_self=True)
    val = torch.where(found, cnt, 0)
    new_pd = torch.where(last >= 0,
                         val.gather(1, torch.clamp(last, min=0)),
                         eng.page_dirty.to(I32))
    throttle = torch.zeros((b, p), dtype=torch.uint8, device=dev)
    throttle = throttle.scatter_reduce(
        1, entry, (found & (cnt == 0)).to(torch.uint8), "amax",
        include_self=True) > 0
    eng = eng._replace(
        page_dirty=new_pd.to(eng.page_dirty.dtype),
        page_state=torch.where(throttle, THROTTLED,
                               eng.page_state).to(eng.page_state.dtype))

    # writeback channel: per module, n lanes of one page each
    m = cfg.fabric.num_modules
    mc = fabric.place(cfg.fabric, torch.clamp(evicted, min=0)).long()
    n_mod = torch.zeros(m, dtype=F32, device=dev).index_add_(
        0, mc.reshape(-1), wb.reshape(-1).to(F32))
    seg = fabric._segment(fab.link, clock)
    seg = seg.reshape(1)
    bw = (fab.link.bw * fab.link.sched_mult.index_select(0, seg)[0]
          * fab.link.health.index_select(0, seg)[0])
    service = page_wire / torch.clamp(bw, min=1e-6)
    busy = torch.where(n_mod > 0,
                       torch.maximum(clock, fab.wb_busy) + n_mod * service,
                       fab.wb_busy)
    fab = fab._replace(wb_busy=busy,
                       wb_bytes=fab.wb_bytes + n_mod * page_wire)
    return eng, fab, wb.sum(dim=1)


def _schedule(eng: EngineState, fab: FabricState, cfg: KVStoreConfig,
              needed_pages, needed_offsets, local_hit, clock
              ) -> Tuple[EngineState, FabricState, torch.Tensor,
                         torch.Tensor, torch.Tensor]:
    """Route every miss through the §4.2 selection unit and serve its
    transfers on the shared fabric: batch order, then request order.

    A page's issue time is its transmission start, so a page queued
    behind a congested module can still be raced by lines. When
    `cfg.adaptive_ratio` is set each request first nudges its module's
    carried partition ratio (`fabric.adapt_ratio_at`).

    Returns (eng', fab', line_sent, page_sent, stall), the last three
    (B, R); `stall` is each request's movement-plane delay in steps (0
    for hits)."""
    b, r = needed_pages.shape
    dp = cfg.daemon
    nominal = float(page_cost_steps(cfg))
    line_wire = _wire_bytes(cfg, 1, False)            # critical token, raw
    page_wire = _wire_bytes(cfg, cfg.page_tokens, cfg.compress_pages)
    lines, pages, stalls, engs = [], [], [], []
    for bi in range(b):
        e = EngineState(*(t[bi] for t in eng))
        for i in range(r):
            pid = needed_pages[bi, i]
            off = needed_offsets[bi, i] % dp.lines_per_page
            mc = fabric.place(cfg.fabric, pid)
            bw = fabric.link_bw_at(fab.link, mc, clock)
            _, page_backlog = fabric.backlog(fab, mc, clock)
            pressure = page_backlog / (page_backlog + nominal)
            send_line, send_page = select_granularity(
                e, pid, clock, selection_enabled=cfg.selection,
                always_both=not cfg.selection, module_pressure=pressure)
            fab = fabric.adapt_ratio_at(
                fab, mc, clock, adaptive=cfg.adaptive_ratio,
                r_idle=dp.bw_ratio, page_unit=page_wire,
                line_occ=utilization(e.sb_key),
                page_occ=utilization(e.page_key))
            page_share = 1.0 - _at(fab.ratio, mc)
            miss = ~local_hit[bi, i]
            do_page = miss & send_page
            do_line = miss & send_line
            # inflight page the request can ride (lookup BEFORE scheduling)
            inflight, pidx = find(e.page_key, pid)
            pending = torch.where(inflight, _at(e.page_arrival, pidx), BIG)
            fab, line_done, page_done = fabric.serve_dual_at(
                fab, mc, partition=True, now=clock,
                line_ready=clock, line_bytes=line_wire, line_gate=do_line,
                page_ready=clock, page_bytes=page_wire, page_gate=do_page)
            # issue = transmission start on the module channel (§4.2)
            page_start = page_done - page_wire / torch.clamp(
                bw * page_share, min=1e-6)
            e = gate_tree(do_page, e,
                          schedule_page(e, pid, page_start, page_done))
            e = gate_tree(do_line, e,
                          schedule_line(e, pid, off, line_done,
                                        dp.lines_per_page))
            served_at = torch.minimum(
                torch.where(do_line, line_done, BIG),
                torch.minimum(torch.where(do_page, page_done, BIG),
                              pending))
            served_at = torch.where(served_at >= BIG / 2, clock + nominal,
                                    served_at)
            stall = torch.where(miss, torch.clamp(served_at - clock,
                                                  min=0.0), 0.0)
            lines.append(do_line)
            pages.append(do_page)
            stalls.append(stall)
        engs.append(e)
    eng = EngineState(*(torch.stack(leaves) for leaves in zip(*engs)))
    shape = (b, r)
    return (eng, fab, torch.stack(lines).reshape(shape),
            torch.stack(pages).reshape(shape),
            torch.stack(stalls).reshape(shape))


def _stats_fold(stats: dict, cfg: KVStoreConfig, line_sent, page_sent,
                stalls, local_hit, n_wb) -> dict:
    """Accrue one step's movement into the (B,) stat counters."""
    r = local_hit.shape[1]
    line_wire = _wire_bytes(cfg, 1, False)
    page_wire = _wire_bytes(cfg, cfg.page_tokens, cfg.compress_pages)
    page_raw = _wire_bytes(cfg, cfg.page_tokens, False)
    n_sub = line_sent.sum(dim=1)
    n_sched = page_sent.sum(dim=1)
    sub_bytes = n_sub * line_wire
    return {
        "sub_block_fetches": stats["sub_block_fetches"] + n_sub,
        "page_moves": stats["page_moves"] + n_sched,
        "wire_bytes": stats["wire_bytes"] + sub_bytes + n_sched * page_wire
        + n_wb * page_wire,
        "uncompressed_bytes": stats["uncompressed_bytes"] + sub_bytes
        + (n_sched + n_wb) * page_raw,
        "local_hits": stats["local_hits"] + local_hit.sum(dim=1),
        "requests": stats["requests"] + r,
        "stall_steps": stats["stall_steps"] + stalls.mean(dim=1),
        "writeback_bytes": stats["writeback_bytes"] + n_wb * page_wire,
        "dirty_evicts": stats["dirty_evicts"] + n_wb,
        "evictions": stats["evictions"],     # accrued at landing
    }


# ------------------------------------------------------------- stepper
def step_fetch_batch(state: BatchedKVStoreState, cfg: KVStoreConfig,
                     remote_k, remote_v, needed_pages, needed_offsets=None,
                     needed_writes=None, policy=None):
    """Serve one decode step for a whole batch: `needed_pages` (B, R).

    `needed_offsets` (B, R) are the requests' token offsets within their
    pages (sub-block keys, default 0); `needed_writes` (B, R) bool marks
    requests that append KV to their page (a written resident page turns
    dirty and owes a writeback when evicted; default all False);
    `policy` overrides `cfg.policy` with a name or PolicyFlags. The local
    pools are updated in place.

    Returns (state, k (B,R,page,KV,D), v, served_local (B,R) bool)."""
    dev = state.clock.device
    needed_pages = torch.as_tensor(needed_pages, device=dev).to(I32)
    b, r = needed_pages.shape
    offs = (torch.zeros_like(needed_pages) if needed_offsets is None
            else torch.as_tensor(needed_offsets, device=dev).to(I32))
    writes = (torch.zeros((b, r), dtype=torch.bool, device=dev)
              if needed_writes is None
              else torch.as_tensor(needed_writes, device=dev).to(torch.bool))
    pol = residency.as_policy(cfg.policy if policy is None else policy,
                              device=dev)
    clock = state.clock + 1.0
    seqs, evicted, k_local, v_local, local_hit = _transact(
        state.seqs, cfg, remote_k, remote_v, clock, pol, needed_pages,
        writes)
    k_remote, v_remote = _remote_fetch(remote_k, remote_v,
                                       needed_pages.reshape(-1),
                                       ~local_hit.reshape(-1),
                                       cfg.kernel_impl)
    row = tuple(k_remote.shape[1:])
    k_remote = k_remote.reshape((b, r) + row)
    v_remote = v_remote.reshape((b, r) + row)
    sel = local_hit.reshape((b, r) + (1,) * len(row))
    k = torch.where(sel, k_local.to(k_remote.dtype), k_remote)
    v = torch.where(sel, v_local.to(v_remote.dtype), v_remote)

    page_wire = _wire_bytes(cfg, cfg.page_tokens, cfg.compress_pages)
    eng, fab, n_wb = _writebacks(seqs.eng, state.fab, cfg, evicted, clock,
                                 page_wire)
    eng, fab, line_sent, page_sent, stalls = _schedule(
        eng, fab, cfg, needed_pages, offs, local_hit, clock)
    stats = _stats_fold(seqs.stats, cfg, line_sent, page_sent, stalls,
                        local_hit, n_wb)
    seqs = seqs._replace(eng=eng, stats=stats)
    return (BatchedKVStoreState(seqs=seqs, fab=fab, clock=clock),
            k, v, local_hit)


def ledger(state: BatchedKVStoreState) -> dict:
    """Host-side movement summary: stats totals summed over the batch +
    the fabric's per-module wire bytes (line + page + writeback)."""
    out = {k: float(v.sum()) for k, v in state.seqs.stats.items()}
    fab = state.fab
    out["module_bytes"] = [
        float(x) for x in (fab.line_bytes + fab.page_bytes + fab.wb_bytes)]
    return out
