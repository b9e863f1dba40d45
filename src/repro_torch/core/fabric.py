"""Movement fabric: per-module link models + channel banks + placement.

PyTorch counterpart of ``repro.core.fabric``: a bank of dual-granularity
virtual channels (line / page / writeback busy-until clocks, one set per
memory module) over a time-varying ``LinkModel`` (per-module base
bandwidth, a piecewise-constant bandwidth-multiplier schedule and a
per-module health mask), the page -> module placement, and per-module
wire-byte ledgers. Channel arithmetic delegates to ``bandwidth``.

Module indices `mc` are 0-d int tensors; every read and update goes
through `gather`/`scatter`, so a transition never reads a value back to
the host. ``reduce_deltas`` merges the ranks' views of the shared bank
over a ``torch.distributed`` process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import bandwidth
from repro_torch.core.engine import _at, _put

F32 = torch.float32
I32 = torch.int32

PLACEMENTS = ("interleave", "hash", "affinity")

# Knuth multiplicative hash constant, as int32 (2654435769 wrapped).
_HASH_MULT = -1640531527


@dataclass(frozen=True)
class FabricConfig:
    """Static fabric shape: module count + placement policy."""
    num_modules: int = 1
    placement: str = "interleave"   # one of PLACEMENTS
    affinity_block: int = 8         # contiguous pages per module (affinity)

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, "
                             f"got {self.placement!r}")
        if self.num_modules < 1:
            raise ValueError("num_modules must be >= 1")


# ------------------------------------------------------------- link model
class LinkModel(NamedTuple):
    """Per-module, time-varying physical link: effective bandwidth of
    module `mc` at time `t` is bw[mc] * sched_mult[seg(t), mc] *
    health[seg(t), mc], seg(t) the active segment of the knot times."""
    bw: torch.Tensor          # (M,) base bandwidth per module
    sched_t: torch.Tensor     # (K,) segment start times, ascending
    sched_mult: torch.Tensor  # (K, M) bandwidth multiplier per segment
    health: torch.Tensor      # (K, M) health mask per segment, in [0, 1]


def constant_link(bw: float, num_modules: int = 1,
                  device=None) -> LinkModel:
    """A time-invariant, fully healthy link: K=1 all-ones schedule."""
    m = num_modules
    return LinkModel(bw=torch.full((m,), bw, dtype=F32, device=device),
                     sched_t=torch.zeros((1,), dtype=F32, device=device),
                     sched_mult=torch.ones((1, m), dtype=F32, device=device),
                     health=torch.ones((1, m), dtype=F32, device=device))


def scheduled_link(bw, schedule, num_modules: int = 1,
                   device=None) -> LinkModel:
    """LinkModel from a (sched_t (K,), mult, health) schedule triple;
    `bw` scalar or (M,), `mult`/`health` (K,) or (K, M)."""
    bw = torch.as_tensor(bw, dtype=F32, device=device)
    if bw.ndim == 0:
        bw = bw.expand(num_modules).clone()
    m = bw.shape[0]
    sched_t, mult, health = schedule
    sched_t = torch.as_tensor(sched_t, dtype=F32, device=device)
    k = sched_t.shape[0]

    def to_km(a):
        a = torch.as_tensor(a, dtype=F32, device=device).reshape(k, -1)
        return a.expand(k, m).contiguous()

    return LinkModel(bw=bw, sched_t=sched_t, sched_mult=to_km(mult),
                     health=to_km(health))


def _segment(link: LinkModel, now) -> torch.Tensor:
    """Active schedule segment at time `now` (0-d int64)."""
    k = link.sched_t.shape[0]
    idx = torch.searchsorted(link.sched_t, now.reshape(1), right=True) - 1
    return torch.clamp(idx, 0, k - 1).reshape(())


def sample_link(link: LinkModel, mc, now
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bandwidth multiplier, health) of module `mc` at time `now`."""
    flat = _segment(link, now) * link.bw.shape[0] + mc
    return (_at(link.sched_mult.reshape(-1), flat),
            _at(link.health.reshape(-1), flat))


def link_bw_at(link: LinkModel, mc, now) -> torch.Tensor:
    """Effective bandwidth of module `mc`'s link at time `now` — the
    only bandwidth sampler."""
    mult, health = sample_link(link, mc, now)
    return _at(link.bw, mc) * mult * health


def module_health(link: LinkModel, now) -> torch.Tensor:
    """(M,) health mask of every module's link at time `now` — what the
    serving loop feeds `runtime.fault.LinkHealthMonitor`."""
    return link.health.index_select(0, _segment(link, now).reshape(1))[0]


# ------------------------------------------------------------ fabric state
class FabricState(NamedTuple):
    """Per-module channel bank + the link it runs over. Busy/byte leaves
    are (M,) f32; `ratio` is the §4.1 line share carried per module;
    `line_rate`/`page_rate` are EMAs of the offered wire bytes."""
    line_busy: torch.Tensor
    page_busy: torch.Tensor
    wb_busy: torch.Tensor
    line_bytes: torch.Tensor
    page_bytes: torch.Tensor
    wb_bytes: torch.Tensor
    ratio: torch.Tensor
    line_rate: torch.Tensor
    page_rate: torch.Tensor
    link: LinkModel


# Demand-rate EMA smoothing per service call.
EMA_ALPHA = 0.08


def init_fabric(cfg: FabricConfig, link: LinkModel = None, ratio=0.25,
                device=None) -> FabricState:
    """Fresh channel bank; `ratio` (a float or a 0-d tensor) seeds the
    carried partition ratio of every module."""
    m = cfg.num_modules
    if link is None:
        link = constant_link(1.0, m, device=device)

    def z():
        return torch.zeros((m,), dtype=F32, device=device)

    if isinstance(ratio, torch.Tensor):
        ratio = ratio.to(F32).expand(m).clone()
    else:
        ratio = torch.full((m,), ratio, dtype=F32, device=device)
    return FabricState(line_busy=z(), page_busy=z(), wb_busy=z(),
                       line_bytes=z(), page_bytes=z(), wb_bytes=z(),
                       ratio=ratio, line_rate=z(), page_rate=z(), link=link)


# ------------------------------------------------------------- placement
def place(cfg: FabricConfig, page_id) -> torch.Tensor:
    """page id -> memory module (int32; int32 wrap-around in `hash`)."""
    page_id = page_id.to(I32)
    m = cfg.num_modules
    if cfg.placement == "interleave":
        return page_id % m
    if cfg.placement == "hash":
        mixed = (page_id * _HASH_MULT) & 0x7FFFFFFF
        return (mixed >> 8) % m
    return torch.div(page_id, cfg.affinity_block,
                     rounding_mode="floor") % m


# ------------------------------------------------------------- occupancy
def backlog(fab: FabricState, mc, now) -> Tuple[torch.Tensor, torch.Tensor]:
    """(line, page) queueing backlog of module `mc` at time `now`."""
    line = torch.clamp(_at(fab.line_busy, mc) - now, min=0.0)
    page = torch.clamp(_at(fab.page_busy, mc) - now, min=0.0)
    return line, page


def total_bytes(fab: FabricState) -> torch.Tensor:
    """Total wire bytes across every module and channel."""
    return fab.line_bytes.sum() + fab.page_bytes.sum() + fab.wb_bytes.sum()


# The FabricState leaves that are accumulated state of the shared memory
# modules (channel clocks, byte ledgers, controller state): every leaf
# but the link model, which is read-only input.
_SHARED_FIELDS = ("line_busy", "page_busy", "wb_busy",
                  "line_bytes", "page_bytes", "wb_bytes",
                  "ratio", "line_rate", "page_rate")


def reduce_deltas(base: FabricState, local: FabricState,
                  group=None) -> FabricState:
    """Merge the ranks' views of the SHARED module channel bank.

    Every rank of `group` (default: the default process group) stepped
    its own copy of the shared bank from the common snapshot `base`;
    each contributed ``local - base`` (busy time it enqueued, bytes it
    moved, controller drift), and the merged bank is ``base + sum of the
    deltas`` over the ranks. Byte ledgers are additive, so two-endpoint
    byte conservation stays exact; busy-time deltas sum as if the ranks'
    demands were serialized on the channel.

    The nine deltas travel as one flat buffer in one `all_gather`, and
    the ranks' deltas are summed in rank order (not by the backend's
    `all_reduce`, whose order gloo and NCCL choose), so every rank and
    every backend gets the same bits; two addends commute, so world 2
    equals the reference's `psum`. The arithmetic is the reference's,
    ``base + (local - base)``, at world 1 too. The link is never
    touched. Raises RuntimeError when no process group is started.
    """
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("reduce_deltas needs a process group: call "
                           "launch.mesh.init_distributed first")
    deltas = [getattr(local, f) - getattr(base, f) for f in _SHARED_FIELDS]
    flat = torch.cat([d.reshape(-1) for d in deltas])
    parts = [torch.empty_like(flat)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    merged, off = {}, 0
    for f, d in zip(_SHARED_FIELDS, deltas):
        merged[f] = getattr(base, f) + total[off:off + d.numel()].reshape(
            d.shape)
        off += d.numel()
    return local._replace(**merged)


# ------------------------------------------------- adaptive repartitioning
def adapt_ratio_at(fab: FabricState, mc, now, *, adaptive, r_idle,
                   page_unit, line_occ=0.0, page_occ=0.0,
                   gain=0.25) -> FabricState:
    """One controller step on module `mc`'s carried partition ratio.

    `adaptive` is a Python bool or a bool tensor. A bool decides on the
    host: False returns `fab` unchanged and launches nothing. A tensor
    computes the new ratio and selects it with `torch.where`, as the
    reference does, so static schemes carry their seed ratio bit for
    bit."""
    if isinstance(adaptive, bool) and not adaptive:
        return fab
    line_bl, page_bl = backlog(fab, mc, now)
    bw = link_bw_at(fab.link, mc, now)
    tau = page_unit / torch.clamp(bw, min=1e-6)
    occ_t = (line_occ + page_occ) * tau
    load_t = line_bl + page_bl + occ_t
    new = bandwidth.adapt_ratio(
        _at(fab.ratio, mc), _at(fab.line_rate, mc), _at(fab.page_rate, mc),
        saturation=load_t / (load_t + tau), r_idle=r_idle, gain=gain)
    if not isinstance(adaptive, bool):
        new = torch.where(adaptive, new, _at(fab.ratio, mc))
    return fab._replace(ratio=_put(fab.ratio, mc, new))


# -------------------------------------------------------------- service
def serve_dual_at(fab: FabricState, mc, *, partition, now,
                  line_ready, line_bytes, line_gate,
                  page_ready, page_bytes, page_gate
                  ) -> Tuple[FabricState, torch.Tensor, torch.Tensor]:
    """One dual-granularity service step on module `mc`'s link: samples
    the bandwidth at `now`, serves through `bandwidth.serve_dual`, and
    accrues the gated bytes and the offered-demand EMAs. `partition` is
    a Python bool or a bool tensor; the byte counts floats or tensors.

    Returns (fabric', line_done, page_done)."""
    bw = link_bw_at(fab.link, mc, now)
    lb, pb, line_done, page_done = bandwidth.serve_dual(
        _at(fab.line_busy, mc), _at(fab.page_busy, mc), partition=partition,
        ratio=_at(fab.ratio, mc), bw=bw,
        line_ready=line_ready, line_bytes=line_bytes, line_gate=line_gate,
        page_ready=page_ready, page_bytes=page_bytes, page_gate=page_gate)
    a = EMA_ALPHA
    zero = torch.zeros((), dtype=F32, device=bw.device)
    line_in = torch.where(line_gate, line_bytes, zero)
    page_in = torch.where(page_gate, page_bytes, zero)
    fab = fab._replace(
        line_busy=_put(fab.line_busy, mc, lb),
        page_busy=_put(fab.page_busy, mc, pb),
        line_bytes=_put(fab.line_bytes, mc, _at(fab.line_bytes, mc)
                        + line_in),
        page_bytes=_put(fab.page_bytes, mc, _at(fab.page_bytes, mc)
                        + page_in),
        line_rate=_put(fab.line_rate, mc,
                       (1 - a) * _at(fab.line_rate, mc) + a * line_in),
        page_rate=_put(fab.page_rate, mc,
                       (1 - a) * _at(fab.page_rate, mc) + a * page_in),
    )
    return fab, line_done, page_done


def serve_writeback_at(fab: FabricState, mc, t_ready, nbytes, *,
                       gate, now=None) -> Tuple[FabricState, torch.Tensor]:
    """Serialize an eviction writeback on module `mc`'s reverse channel
    at the link bandwidth sampled at `now` (defaults to `t_ready`)."""
    bw = link_bw_at(fab.link, mc, t_ready if now is None else now)
    busy, done = bandwidth.occupy_busy(_at(fab.wb_busy, mc), t_ready,
                                       nbytes, bw, gate=gate)
    zero = torch.zeros((), dtype=F32, device=bw.device)
    fab = fab._replace(
        wb_busy=_put(fab.wb_busy, mc, busy),
        wb_bytes=_put(fab.wb_bytes, mc, _at(fab.wb_bytes, mc)
                      + torch.where(gate, nbytes, zero)),
    )
    return fab, done
