"""DaemonKVStore: two-tier paged KV cache with DaeMon movement policies.

PyTorch counterpart of ``repro.core.daemon_store``. Tenant sequences,
each with its own local page pool, page table (``residency``) and
movement engine (``engine``), contend for ONE memory-side movement
fabric (``fabric``). Per decode step the steppers:

  1. run the residency transaction for every sequence at once
     (`_transact` -> ``ops.residency_fused``: landing, victim choice,
     dirty-eviction list, pool scatter, CAM probe, hit gather, touch) —
     one CUDA kernel launch on the card; `kernel_impl="chain"` runs the
     reference's per-primitive comparator instead (`_land` + `_lookup`,
     whose gathers are the paged-gather kernel on the card);
  2. serve misses through the sub-block plane from the remote tier
     (`_remote_fetch` -> ``ops.paged_gather_pair``, hit rows masked off);
  3. schedule the misses' transfers on the shared fabric (`_schedule`
     -> ``ops.schedule_fold``, one kernel launch on the card): §4.2
     granularity selection, §4.1 partitioned channels; and the §4.3
     writeback path for dirty evictions (`_writebacks`).

Three steppers share that step: `step_fetch` (one sequence, the batched
path at B = 1), `step_fetch_batch` (B sequences) and
`step_fetch_replicated` (C serving replicas x B tenants, C*B sequences
flattened replica-major). The replicated store adds a per-replica NIC
bank (``compute_plane``): every transfer is priced on the shared module's
channels and on the owning replica's NIC, arrival the later completion;
with C = 1 the NIC leg is gated off and the step is `step_fetch_batch`
bit for bit.

State is NamedTuples of tensors with a leading sequence axis; the fabric
is shared. The pools are updated in place by the transaction. No step
reads a value back to the host: the reference's `lax.cond`s, which only
skip work, become masks, and the reference's scheduling scan is one
kernel launch on the card (`ops.schedule_fold`).

`_schedule` keeps the reference's order. The writeback half touches
only the engines' dirty counters and the writeback channels of the
module and NIC banks (``wb_busy``/``wb_bytes``), which nothing in the
request half reads (`fabric.backlog` and `serve_dual_at` read the line
and page channels only), so it runs first for every sequence, vectorised
over lanes; the request half then folds over the sequences in order and
over each sequence's requests, with the shared banks as carry.
Writeback busy clocks are summed as n * service time per module (and per
NIC unit) rather than n sequential additions (equal to within float
rounding).

With telemetry on (`KVStoreConfig.telemetry`), each sequence carries a
stall histogram and a series ring (`SeqState.tel`); a sequence's series
row reads the fabric as it stands after that sequence's requests, as the
reference's per-sequence fold does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import compute_plane, fabric, residency, telemetry
from repro_torch.core.compute_plane import mean_last
from repro_torch.core.engine import (EngineState, THROTTLED,
                                     init_engine_state, poll_arrivals,
                                     retire_arrivals)
from repro_torch.core.fabric import FabricConfig, FabricState, LinkModel
from repro_torch.core.params import DaemonParams
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

F32 = torch.float32
I32 = torch.int32

# hot-path implementations: "auto" = the CUDA kernels on CUDA tensors,
# their plain versions on CPU tensors; "cuda"/"ref" force one side;
# "chain" = the reference's per-primitive comparator (`_land`/`_lookup`)
KERNEL_IMPLS = ops.IMPLS + ("chain",)


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
    kernel_impl: str = "auto"     # hot-path impl: auto|cuda|ref|chain
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
    # per-tenant instruments; None when telemetry is off
    tel: telemetry.TelemetryState = None


class KVStoreState(NamedTuple):
    """One sequence against its own fabric (`step_fetch`)."""
    seq: SeqState
    fab: FabricState
    clock: torch.Tensor           # 0-d f32 decode-step counter

    @property
    def eng(self) -> EngineState:
        return self.seq.eng

    @property
    def stats(self) -> dict:
        return self.seq.stats


class BatchedKVStoreState(NamedTuple):
    seqs: SeqState                # leaves have a leading (B,) axis
    fab: FabricState              # ONE bank shared by the whole batch
    clock: torch.Tensor           # 0-d f32 decode-step counter

    @property
    def stats(self) -> dict:
        return self.seqs.stats


class ReplicatedKVStoreState(NamedTuple):
    """C serving replicas x B tenants: sequence leaves carry a leading
    (C*B,) axis, replica-major (sequence i belongs to replica i // B);
    `fab` is the one memory-side bank every replica contends on, `nic`
    the per-replica NIC bank (C units)."""
    seqs: SeqState
    fab: FabricState
    nic: FabricState
    clock: torch.Tensor

    @property
    def num_replicas(self) -> int:
        return self.nic.line_busy.shape[0]

    @property
    def batch(self) -> int:
        return self.seqs.res.page.shape[0] // self.num_replicas

    @property
    def stats(self) -> dict:
        return self.seqs.stats


STAT_KEYS = ("sub_block_fetches", "page_moves", "wire_bytes",
             "uncompressed_bytes", "local_hits", "requests", "stall_steps",
             "writeback_bytes", "dirty_evicts", "evictions")

# per-decode-step series channels the telemetry ring samples
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
        tel=telemetry.init_state(cfg.telemetry, len(SERIES_CHANNELS),
                                 device=device),
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


def _zero_clock(device) -> torch.Tensor:
    return torch.zeros((), dtype=F32, device=device)


def init_kv_store(cfg: KVStoreConfig, link: LinkModel = None,
                  device=None) -> KVStoreState:
    """One fresh sequence and its fabric, on the card unless `device`
    says otherwise. `link` (optional) is a time-varying LinkModel whose
    knot times are decode steps."""
    device = resolve_device(device)
    return KVStoreState(seq=_init_seq(cfg, device),
                        fab=_init_fab(cfg, link, device),
                        clock=_zero_clock(device))


def init_kv_store_batch(cfg: KVStoreConfig, batch: int,
                        link: LinkModel = None,
                        device=None) -> BatchedKVStoreState:
    """B fresh sequences against one fabric, on the card unless `device`
    says otherwise."""
    device = resolve_device(device)
    seqs = compute_plane.replicate(_init_seq(cfg, device), batch)
    return BatchedKVStoreState(seqs=seqs, fab=_init_fab(cfg, link, device),
                               clock=_zero_clock(device))


def init_kv_store_replicated(cfg: KVStoreConfig, num_replicas: int,
                             batch: int, link: LinkModel = None,
                             nic_link: LinkModel = None,
                             device=None) -> ReplicatedKVStoreState:
    """C replicas x B tenants against one shared memory-side fabric, on
    the card unless `device` says otherwise. `nic_link` overrides the
    per-replica NIC link, which otherwise derives from the memory link
    (`compute_plane.nic_link_for`)."""
    device = resolve_device(device)
    seqs = compute_plane.replicate(_init_seq(cfg, device),
                                   num_replicas * batch)
    fab = _init_fab(cfg, link, device)
    if nic_link is None:
        nic_link = compute_plane.nic_link_for(fab.link, num_replicas)
    nic = compute_plane.init_nic_bank(num_replicas, link=nic_link,
                                      ratio=cfg.daemon.bw_ratio)
    return ReplicatedKVStoreState(seqs=seqs, fab=fab, nic=nic,
                                  clock=_zero_clock(device))


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
def _ops_impl(cfg: KVStoreConfig) -> str:
    """The `kernels.ops` implementation the step's gathers run under:
    the chain comparator gathers through the kernels like "auto"."""
    return "auto" if cfg.kernel_impl == "chain" else cfg.kernel_impl


def _transact(seqs: SeqState, cfg: KVStoreConfig, remote_k, remote_v,
              clock, pol: residency.PolicyFlags, needed_pages,
              needed_writes):
    """The fused residency transaction for the stacked sequences: one
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


def _land(seqs: SeqState, cfg: KVStoreConfig, remote_k, remote_v, clock,
          pol: residency.PolicyFlags) -> Tuple[SeqState, torch.Tensor]:
    """The chain's landing for the stacked sequences: each sequence's
    arrived in-flight pages, compacted to the front in slot order, take
    the rank-j victims of their own sets (`residency.landing_victims`);
    lanes past a set's W ways, and lanes that did not land, are dropped.
    Returns (seqs', evicted (B, k) int32): the page ids of the dirty
    resident pages the landing evicted, -1 elsewhere.

    The reference vmaps this per sequence and skips it with `lax.cond`
    when nothing landed; here every lane is masked instead. The landed
    rows come from one gather over the batch's lanes (the paged-gather
    kernel on the card, lanes that did not land not read), and land in
    the pools viewed flat as (B*N, row) at `b*N + slot`; a dropped lane
    targets B*N, out of range, so it can never clobber a live landing."""
    landed, landed_pages = poll_arrivals(seqs.eng, clock)
    b, p = landed.shape
    w = seqs.res.page.shape[-1]
    n = cfg.num_local_pages
    k_land = min(p, n)
    impl = _ops_impl(cfg)
    order = torch.sort((~landed).to(I32), dim=1, stable=True).indices
    pick = order[:, :k_land]
    do = landed.gather(1, pick)
    pids = landed_pages.to(I32).gather(1, pick)
    rows = torch.clamp(pids, min=0).reshape(-1)
    page_k = ops.paged_gather(remote_k, rows, do.reshape(-1), impl=impl)
    page_v = ops.paged_gather(remote_v, rows, do.reshape(-1), impl=impl)
    sets, vways, ok = residency.landing_victims(seqs.res, pids, pol)
    do = do & ok
    victims = (sets * w + vways).long()
    vict_page = residency._flat(seqs.res.page).gather(1, victims)
    resident = vict_page >= 0
    dirty = residency._flat(seqs.res.dirty).gather(1, victims)
    evicted = torch.where(do & dirty & resident, vict_page, -1).to(I32)
    base = torch.arange(b, device=victims.device)[:, None] * n
    tgt = torch.where(do, base + victims, b * n).reshape(-1)
    row = tuple(seqs.kpool.shape[2:])
    kpool, vpool = seqs.kpool, seqs.vpool
    ops.paged_scatter(kpool.view((b * n,) + row), tgt,
                      page_k.to(kpool.dtype), mode="drop")
    ops.paged_scatter(vpool.view((b * n,) + row), tgt,
                      page_v.to(vpool.dtype), mode="drop")
    # a freshly landed page is a clean remote copy (dirty=False)
    res = residency.insert(seqs.res, sets, vways, pids, now=clock,
                           ready=clock, dirty=False, gate=do)
    stats = {**seqs.stats,
             "evictions": seqs.stats["evictions"]
             + (do & resident).sum(dim=1).to(F32)}
    eng = retire_arrivals(seqs.eng, clock, cfg.daemon.lines_per_page)
    return seqs._replace(res=res, stats=stats, eng=eng), evicted


def _lookup(seqs: SeqState, cfg: KVStoreConfig, clock, needed_pages,
            needed_writes, pol: residency.PolicyFlags):
    """The chain's CAM lookup and local serve, after landing (a page
    that lands this step hits now): probe gated by `ready <= clock`, one
    gather of the probed slots over the batch's flat pools (a miss reads
    its set's way 0, as the reference does), then the policy touch and
    the dirty bit on written hits. Returns (seqs', k_local, v_local,
    local_hit)."""
    present, set_idx, way, ready_ok = residency.lookup(seqs.res,
                                                       needed_pages, clock)
    local_hit = present & ready_ok
    b, r = needed_pages.shape
    n = cfg.num_local_pages
    w = seqs.res.page.shape[-1]
    base = torch.arange(b, device=set_idx.device)[:, None] * n
    slot = (base + set_idx * w + way).reshape(-1)
    row = tuple(seqs.kpool.shape[2:])
    impl = _ops_impl(cfg)
    k_local = ops.paged_gather(seqs.kpool.view((b * n,) + row), slot,
                               impl=impl).reshape((b, r) + row)
    v_local = ops.paged_gather(seqs.vpool.view((b * n,) + row), slot,
                               impl=impl).reshape((b, r) + row)
    res = residency.touch(seqs.res, set_idx, way, clock, pol,
                          gate=local_hit)
    res = residency.mark_dirty(res, set_idx, way, needed_writes,
                               gate=local_hit)
    return seqs._replace(res=res), k_local, v_local, local_hit


def _residency(seqs: SeqState, cfg: KVStoreConfig, remote_k, remote_v,
               clock, pol, needed_pages, needed_writes):
    """The step's residency transaction: the fused one, or the chain
    comparator when `cfg.kernel_impl == "chain"` (equal on every
    output)."""
    if cfg.kernel_impl != "chain":
        return _transact(seqs, cfg, remote_k, remote_v, clock, pol,
                         needed_pages, needed_writes)
    seqs, evicted = _land(seqs, cfg, remote_k, remote_v, clock, pol)
    seqs, k_local, v_local, local_hit = _lookup(seqs, cfg, clock,
                                                needed_pages, needed_writes,
                                                pol)
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
    return eng, _bulk_writeback(fab, n_mod, clock, page_wire), wb.sum(dim=1)


def _bulk_writeback(bank: FabricState, n, clock, page_wire: float
                    ) -> FabricState:
    """Serialize `n` (per channel) pages of `page_wire` bytes on a
    bank's writeback channels at the link sampled at `clock`: n service
    times past max(clock, busy), where the reference adds them one page
    at a time (equal to within float rounding). A channel with n = 0 is
    left as it was, bit for bit."""
    seg = fabric._segment(bank.link, clock).reshape(1)
    bw = (bank.link.bw * bank.link.sched_mult.index_select(0, seg)[0]
          * bank.link.health.index_select(0, seg)[0])
    service = page_wire / torch.clamp(bw, min=1e-6)
    busy = torch.where(n > 0,
                       torch.maximum(clock, bank.wb_busy) + n * service,
                       bank.wb_busy)
    return bank._replace(wb_busy=busy, wb_bytes=bank.wb_bytes + n * page_wire)


def _nic_writebacks(nic: FabricState, n_wb, cus, active, clock,
                    page_wire: float) -> FabricState:
    """The NIC leg of the step's writebacks: each unit's writeback
    channel serializes the pages its sequences wrote back (`n_wb` (B,),
    `cus` (B,) owning units). Gated off (the bank untouched) unless
    `active`."""
    n_unit = torch.zeros(nic.wb_busy.shape[0], dtype=F32,
                         device=nic.wb_busy.device
                         ).index_add_(0, cus.long(), n_wb.to(F32))
    return _bulk_writeback(nic, torch.where(active, n_unit, 0.0), clock,
                           page_wire)


def _fold_statics(cfg: KVStoreConfig) -> ops.FoldStatics:
    """The request fold's static choices for `cfg`."""
    return ops.FoldStatics(
        fabric=cfg.fabric, selection=cfg.selection,
        adaptive_ratio=cfg.adaptive_ratio,
        lines_per_page=cfg.daemon.lines_per_page,
        r_idle=cfg.daemon.bw_ratio, nominal=float(page_cost_steps(cfg)),
        line_wire=_wire_bytes(cfg, 1, False),        # critical token, raw
        page_wire=_wire_bytes(cfg, cfg.page_tokens, cfg.compress_pages))


def _schedule(eng: EngineState, fab: FabricState, cfg: KVStoreConfig,
              needed_pages, needed_offsets, local_hit, clock, nic=None,
              cus=None, active=None):
    """Route every miss through the §4.2 selection unit and serve its
    transfers on the shared fabric: sequence order, then request order.

    A page's issue time is its transmission start on the module channel,
    so a page queued behind a congested module can still be raced by
    lines. When `cfg.adaptive_ratio` is set each request first nudges
    its module's carried partition ratio (`fabric.adapt_ratio_at`).
    With a NIC bank `nic`, `cus` (B,) the sequences' units and `active`
    the NIC gate, every transfer is priced on both legs
    (`compute_plane.serve_dual_two_leg`).

    One `ops.schedule_fold` call: one kernel launch on the card
    (``csrc/schedule_fold.cu``), the plain fold (`ref.schedule_fold`) on
    CPU tensors or under `kernel_impl="ref"`.

    Returns (eng', fab', nic', line_sent, page_sent, stall, seen): the
    middle three (B, R), `stall` each request's movement-plane delay in
    steps (0 for hits); `seen` lists each sequence's (page_busy, ratio)
    of the fabric after its requests, for the telemetry series."""
    return ops.schedule_fold(eng, fab, needed_pages, needed_offsets,
                             local_hit, clock, _fold_statics(cfg), nic=nic,
                             cus=cus, active=active, impl=_ops_impl(cfg))


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
        "stall_steps": stats["stall_steps"] + mean_last(stalls),
        "writeback_bytes": stats["writeback_bytes"] + n_wb * page_wire,
        "dirty_evicts": stats["dirty_evicts"] + n_wb,
        "evictions": stats["evictions"],     # accrued at landing
    }


def _record_telemetry(tel, cfg: KVStoreConfig, stalls, local_hit, stats,
                      seen, link: LinkModel, clock):
    """Record the step in each sequence's instruments, as the reference
    does at the end of its per-sequence fold: every request's stall in
    the histogram, and one series row per sequence (page backlog and
    ratio of the fabric after that sequence's requests, its hit rate,
    evictions and writeback bytes, the mean module health)."""
    tcfg = cfg.telemetry
    if tel is None or not tcfg.enabled:
        return tel
    tel = telemetry.record_latency(tel, tcfg, stalls)
    page_busy = torch.stack([pb for pb, _ in seen])           # (B, M)
    ratio = torch.stack([ra for _, ra in seen])
    health = mean_last(fabric.module_health(link, clock))
    rows = torch.stack([
        mean_last(torch.clamp(page_busy - clock, min=0.0)),
        mean_last(ratio),
        mean_last(local_hit.to(F32)),
        stats["evictions"],
        stats["writeback_bytes"],
        health.expand(page_busy.shape[0]),
    ], dim=1)
    return telemetry.record_series(tel, tcfg, (clock - 1.0).to(I32), rows)


# ------------------------------------------------------------- steppers
def _inputs(dev, needed_pages, needed_offsets, needed_writes, shape):
    """The step's requests as (pages, offsets, writes) of `shape` on
    `dev`: offsets default to 0, writes to all False."""
    pages = torch.as_tensor(needed_pages, device=dev).to(I32).reshape(shape)
    offs = (torch.zeros(shape, dtype=I32, device=dev)
            if needed_offsets is None else
            torch.as_tensor(needed_offsets, device=dev).to(I32)
            .reshape(shape))
    writes = (torch.zeros(shape, dtype=torch.bool, device=dev)
              if needed_writes is None else
              torch.as_tensor(needed_writes, device=dev).to(torch.bool)
              .reshape(shape))
    return pages, offs, writes


def _step(seqs: SeqState, fab: FabricState, clock, cfg: KVStoreConfig,
          remote_k, remote_v, needed_pages, offs, writes, policy,
          nic=None, cus=None, active=None):
    """One decode step for the stacked sequences (`needed_pages` (B, R));
    `clock` is the step's (already advanced) time. Returns (seqs', fab',
    nic', k (B,R,page,KV,D), v, served_local (B,R) bool). Its layer
    spans (``telemetry.span``): `store.step` and its five parts."""
    b, r = needed_pages.shape
    with telemetry.span("store.step", requests=b * r):
        pol = residency.as_policy(cfg.policy if policy is None else policy,
                                  device=clock.device)
        with telemetry.span("store.residency"):
            seqs, evicted, k_local, v_local, local_hit = _residency(
                seqs, cfg, remote_k, remote_v, clock, pol, needed_pages,
                writes)
        with telemetry.span("store.remote_fetch"):
            k_remote, v_remote = _remote_fetch(remote_k, remote_v,
                                               needed_pages.reshape(-1),
                                               ~local_hit.reshape(-1),
                                               _ops_impl(cfg))
            row = tuple(k_remote.shape[1:])
            k_remote = k_remote.reshape((b, r) + row)
            v_remote = v_remote.reshape((b, r) + row)
            sel = local_hit.reshape((b, r) + (1,) * len(row))
            k = torch.where(sel, k_local.to(k_remote.dtype), k_remote)
            v = torch.where(sel, v_local.to(v_remote.dtype), v_remote)

        page_wire = _wire_bytes(cfg, cfg.page_tokens, cfg.compress_pages)
        with telemetry.span("store.writebacks"):
            eng, fab, n_wb = _writebacks(seqs.eng, fab, cfg, evicted, clock,
                                         page_wire)
            if nic is not None:
                nic = _nic_writebacks(nic, n_wb, cus, active, clock,
                                      page_wire)
        with telemetry.span("store.schedule"):
            eng, fab, nic, line_sent, page_sent, stalls, seen = _schedule(
                eng, fab, cfg, needed_pages, offs, local_hit, clock, nic=nic,
                cus=cus, active=active)
        with telemetry.span("store.fold"):
            stats = _stats_fold(seqs.stats, cfg, line_sent, page_sent,
                                stalls, local_hit, n_wb)
            tel = _record_telemetry(seqs.tel, cfg, stalls, local_hit, stats,
                                    seen, fab.link, clock)
        seqs = seqs._replace(eng=eng, stats=stats, tel=tel)
    return seqs, fab, nic, k, v, local_hit


def step_fetch(state: KVStoreState, cfg: KVStoreConfig, remote_k,
               remote_v, needed_pages, needed_offsets=None,
               needed_writes=None, policy=None):
    """Serve one decode step of one sequence needing `needed_pages` (R,):
    the batched step at B = 1, as the reference's `step_fetch` is.
    `needed_offsets`, `needed_writes` and `policy` as in
    `step_fetch_batch`. Returns (state, k (R,page,KV,D), v,
    served_local (R,) bool)."""
    dev = state.clock.device
    r = torch.as_tensor(needed_pages).reshape(-1).shape[0]
    pages, offs, writes = _inputs(dev, needed_pages, needed_offsets,
                                  needed_writes, (1, r))
    seqs = compute_plane.tree_map(lambda x: x.unsqueeze(0), state.seq)
    clock = state.clock + 1.0
    seqs, fab, _, k, v, hit = _step(seqs, state.fab, clock, cfg, remote_k,
                                    remote_v, pages, offs, writes, policy)
    seq = compute_plane.tree_map(lambda x: x[0], seqs)
    return KVStoreState(seq=seq, fab=fab, clock=clock), k[0], v[0], hit[0]


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
    shape = tuple(torch.as_tensor(needed_pages).shape)
    pages, offs, writes = _inputs(dev, needed_pages, needed_offsets,
                                  needed_writes, shape)
    clock = state.clock + 1.0
    seqs, fab, _, k, v, hit = _step(state.seqs, state.fab, clock, cfg,
                                    remote_k, remote_v, pages, offs, writes,
                                    policy)
    return BatchedKVStoreState(seqs=seqs, fab=fab, clock=clock), k, v, hit


def step_fetch_replicated(state: ReplicatedKVStoreState,
                          cfg: KVStoreConfig, remote_k, remote_v,
                          needed_pages, needed_offsets=None,
                          needed_writes=None, policy=None, active=None):
    """Serve one decode step for C replicas x B tenants: `needed_pages`
    (C, B, R), replica-major like the state.

    The C*B sequences run one residency transaction and one remote fetch
    (one launch each on the card); scheduling folds over them in
    replica-major order with both banks as carry: the shared memory-side
    fabric and the per-replica NIC bank (each replica's transfers also
    serialize on its own ingress, arrival the later completion).

    `active` overrides the NIC gate (default C > 1); a caller stepping a
    local slice of a larger deployment passes the whole deployment's
    gate. With the gate off this is `step_fetch_batch` bit for bit and
    the NIC bank stays untouched.

    Returns (state, k (C,B,R,page,KV,D), v, served_local (C,B,R))."""
    dev = state.clock.device
    c, b, r = tuple(torch.as_tensor(needed_pages).shape)
    pages, offs, writes = _inputs(dev, needed_pages, needed_offsets,
                                  needed_writes, (c * b, r))
    cus = torch.div(torch.arange(c * b, device=dev), b,
                    rounding_mode="floor")
    active = torch.as_tensor(c > 1 if active is None else active,
                             dtype=torch.bool, device=dev)
    clock = state.clock + 1.0
    seqs, fab, nic, k, v, hit = _step(state.seqs, state.fab, clock, cfg,
                                      remote_k, remote_v, pages, offs,
                                      writes, policy, nic=state.nic,
                                      cus=cus, active=active)
    kv_shape = (c, b, r) + tuple(k.shape[2:])
    return (ReplicatedKVStoreState(seqs=seqs, fab=fab, nic=nic,
                                   clock=clock),
            k.reshape(kv_shape), v.reshape(kv_shape), hit.reshape((c, b, r)))


def ledger(state) -> dict:
    """Host-side movement summary of a KVStoreState, BatchedKVStoreState
    or ReplicatedKVStoreState: stats totals over the sequences (summed in
    float64, so the same on every device) + the fabric's per-module wire
    bytes (line + page + writeback), + each replica's NIC bytes
    (`unit_bytes`) for a replicated store. With telemetry at the
    histogram level or above, the summed stall histogram adds
    `stall_p50_steps` / `stall_p90_steps` / `stall_p99_steps`."""
    seq = state.seq if isinstance(state, KVStoreState) else state.seqs
    out = {k: float(v.detach().double().sum())
           for k, v in seq.stats.items()}
    if seq.tel is not None:
        p50, p90, p99 = telemetry.percentiles_from_state(
            seq.tel, [0.5, 0.9, 0.99])
        out["stall_p50_steps"] = p50
        out["stall_p90_steps"] = p90
        out["stall_p99_steps"] = p99
    fab = state.fab
    out["module_bytes"] = [
        float(x) for x in (fab.line_bytes + fab.page_bytes + fab.wb_bytes)]
    if isinstance(state, ReplicatedKVStoreState):
        out["unit_bytes"] = [
            float(x) for x in compute_plane.unit_bytes(state.nic)]
    return out
