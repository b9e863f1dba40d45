"""Request-level discrete-event simulator of a fully disaggregated system.

PyTorch counterpart of ``repro.sim.desim``: LLC-miss traces replayed
through local memory (``repro_torch.core.residency``: one set-associative
page table per compute unit with policy-scored eviction), the DaeMon
engines (``core.engine``: inflight buffers and the selection unit), and
the shared movement fabric (``core.fabric``: per-module partitioned
virtual channels over the network and the remote-memory bus, each service
delegating to ``core.bandwidth.serve_dual``), page -> module placement,
link compression and an MLP-window core model. Network variability is the
fabric's ``LinkModel``, sampled at each request's issue time; ``make_net``
attaches a schedule. ``SimConfig.num_cu`` sizes the compute units: each
owns its MLP ring, page table, engines and NIC channel bank, and every
network transfer is priced on the module and on the unit's NIC
(``core.compute_plane``), the NIC leg gated off when one unit is active.

One lattice point is written as the reference writes it: ``make_step`` is
the per-request transition on 0-d tensors, and ``_simulate_point`` runs it
over the trace in a Python loop (the reference's ``lax.scan``).
``simulate_lattice`` lifts that point over schemes x nets x compute-unit
counts x policies with ``torch.func.vmap`` (one level over the flattened
product, see ``_lattice``), so each request of the whole lattice is one
pass of batched launches. Scheme flags, policies, link schedules
and the active-unit count are tensors on the lattice's axes, so every
switch in the step is a ``torch.where``; Python control flow on them
would raise under vmap. The request loop reads nothing back to the host:
the metrics are copied once, at the end of a lattice.

The arithmetic keeps the reference's order, because discrete outcomes
hang on float comparisons of clocks (``ready <= now``, the line/page
race, ``cand >= BIG / 2``): numerators are f32 tensors (PyTorch turns
``float / tensor`` into a reciprocal times the float), and means are
``compute_plane.mean_last``, XLA:CPU's in-order sum.

Entry points run on the card unless called with ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core import (bandwidth, compute_plane, fabric, residency,
                              telemetry)
from repro_torch.core.engine import (EngineState, _at, find,
                                     gate_tree as _gate_tree,
                                     init_engine_state, retire_arrivals,
                                     schedule_line, schedule_page,
                                     select_granularity, utilization)
from repro_torch.core.params import DaemonParams, NetworkParams
from repro_torch.core.residency import POLICIES, ResidencyState
from repro_torch.device import resolve_device
from repro_torch.sim.schemes import as_traceable, stack_flags
from repro_torch.sim.trace import Trace

F32 = torch.float32
I32 = torch.int32
BIG = 3.0e38
WAYS = 8
MLP_W = 16


@dataclass(frozen=True)
class SimConfig:
    daemon: DaemonParams = DaemonParams()
    local_frac: float = 0.20      # local memory holds ~20% of the footprint
    # DEPRECATED alias for the policy registry: POLICIES["fifo"] /
    # POLICIES["lru"] when no explicit policy is given (`default_policy`)
    fifo: bool = False
    num_mc: int = 1               # memory components (fig 17/22)
    mlp: int = MLP_W
    placement: str = "interleave"  # page->module policy (fabric.PLACEMENTS)
    # compute-unit ENVELOPE (fig 22): sizes the per-unit state; how many
    # units receive requests is data (`simulate_lattice(active_cus=)`)
    num_cu: int = 1

    def fabric_config(self) -> fabric.FabricConfig:
        return fabric.FabricConfig(num_modules=self.num_mc,
                                   placement=self.placement)

    def compute_config(self) -> compute_plane.ComputePlaneConfig:
        return compute_plane.ComputePlaneConfig(num_units=self.num_cu)

    def default_policy(self) -> residency.PolicySpec:
        """The `SimConfig.fifo` alias mapping (deprecation shim)."""
        return POLICIES["fifo" if self.fifo else "lru"]


class SimState(NamedTuple):
    """Per-compute-unit leaves carry a leading (C,) axis (C = num_cu);
    `net`/`mem` are the shared per-module banks all units contend on;
    `nic` is the compute-side per-unit channel bank."""
    t: torch.Tensor              # (C,) per-unit core clock
    ring: torch.Tensor           # (C, W) outstanding completions per unit
    res: ResidencyState          # local-memory tier, leaves (C, SETS, WAYS)
    eng: EngineState             # leaves (C, ...): one engine per unit
    net: fabric.FabricState      # network-link channel bank (M modules)
    mem: fabric.FabricState      # remote-memory bus channel bank
    nic: fabric.FabricState      # compute-side NIC bank (C units)
    stats: dict
    # telemetry plane: None below level="counters"
    tel: telemetry.TelemetryState = None


STAT_KEYS = ("i", "n", "hits", "lat_sum", "pages_moved", "lines_moved",
             "net_bytes", "wb_bytes", "served_line", "served_page",
             "page_drops", "dirty_evicts", "evictions")

# per-request series channels the telemetry ring samples (at the touched
# module / requesting unit, plus the running stats ratios)
SERIES_CHANNELS = ("page_backlog_ns", "ratio", "hit_rate", "evictions",
                   "wb_bytes", "health")

# `telemetry_cfg=None` normalizes to this off config
_TEL_OFF = telemetry.TelemetryConfig()


def _full(val, dev, dtype=F32) -> torch.Tensor:
    """A 0-d constant filled on `dev` (no copy from the host)."""
    return torch.full((), val, dtype=dtype, device=dev)


def _net_link(net) -> fabric.LinkModel:
    """The network-side LinkModel carried by a net dict (see `make_net`)."""
    return fabric.LinkModel(bw=net["bw"], sched_t=net["sched_t"],
                            sched_mult=net["sched_mult"],
                            health=net["sched_health"])


def _mem_link(membw, num_mc: int) -> fabric.LinkModel:
    """The remote-memory bus: a constant, fully healthy link of bandwidth
    `membw` (a 0-d tensor) on every module."""
    dev = membw.device
    return fabric.LinkModel(
        bw=membw.expand(num_mc).clone(),
        sched_t=torch.zeros((1,), dtype=F32, device=dev),
        sched_mult=torch.ones((1, num_mc), dtype=F32, device=dev),
        health=torch.ones((1, num_mc), dtype=F32, device=dev))


def _init_state(cfg: SimConfig, n_pages: int, net, ratio0,
                telcfg: telemetry.TelemetryConfig = None) -> SimState:
    dev = ratio0.device
    sets = residency.geometry(n_pages, cfg.local_frac, WAYS)
    c = cfg.num_cu
    fcfg = cfg.fabric_config()
    net_link = _net_link(net)
    return SimState(
        t=torch.zeros((c,), dtype=F32, device=dev),
        ring=torch.zeros((c, cfg.mlp), dtype=F32, device=dev),
        res=compute_plane.replicate(
            residency.init_residency(sets, WAYS, device=dev), c),
        eng=compute_plane.replicate(init_engine_state(cfg.daemon, dev), c),
        net=fabric.init_fabric(fcfg, link=net_link, ratio=ratio0,
                               device=dev),
        mem=fabric.init_fabric(fcfg, link=_mem_link(net["membw"],
                                                    cfg.num_mc),
                               ratio=ratio0, device=dev),
        nic=compute_plane.init_nic_bank(
            c, link=compute_plane.nic_link_for(net_link, c), ratio=ratio0),
        stats={k: torch.zeros((), dtype=F32, device=dev)
               for k in STAT_KEYS},
        tel=telemetry.init_state(telcfg, len(SERIES_CHANNELS), device=dev),
    )


def _one(tree):
    """One (S, W) table as a batch of one, for the store's batched
    residency mutations."""
    return compute_plane.tree_map(lambda t: t.unsqueeze(0), tree)


def _row(tree):
    return compute_plane.tree_map(lambda t: t[0], tree)


def _cell(x) -> torch.Tensor:
    """A 0-d argument as the (1, 1) request grid of a batch of one."""
    return x.reshape(1, 1)


def make_step(flags, cfg: SimConfig, net, comp_ratio, warm_after,
              active_cu, policy=None,
              telcfg: telemetry.TelemetryConfig = None):
    """Per-request transition. `flags` (TraceableFlags), `net` (a dict of
    tensors; the link itself rides in the fabric state), `comp_ratio`,
    `warm_after` and `active_cu` are tensors of one lattice point, and
    `policy` a PolicyFlags of tensors (or a PolicySpec or name; defaults
    to the `SimConfig.fifo` alias); all are closed over. Every scheme
    switch below is a `torch.where`."""
    fl = as_traceable(flags)
    dev = fl.bw_ratio.device
    pol = residency.as_policy(cfg.default_policy() if policy is None
                              else policy, dev)
    dp = cfg.daemon
    comp_lat = _full(dp.compress_latency_ns, dev)
    zero = _full(0.0, dev)
    line_b = _full(float(dp.line_bytes), dev)
    page_b = _full(float(dp.page_bytes), dev)
    lpp = dp.lines_per_page
    fcfg = cfg.fabric_config()
    membw = net["membw"]
    local_lat = net["local_lat"]
    remote_lat = net["remote_lat"]
    trans_lat = net["trans_lat"]
    switch = net["switch"]

    def step(st: SimState, inp):
        page, off, gap, wr = inp
        want_page = (fl.move_pages | fl.page_free) & fl.use_local_mem

        # ---- compute-unit sharding (page hash; active_cu == 1 -> unit 0)
        # unit, module and set indices as int64 once: every gather and
        # scatter below takes them without another conversion
        cu = compute_plane.shard_unit(page, active_cu).long()
        nic_on = active_cu > 1            # NIC leg gate (idle at C=1)
        ring_u = compute_plane.unit_slice(st.ring, cu)
        res_u = compute_plane.unit_slice(st.res, cu)
        eng = compute_plane.unit_slice(st.eng, cu)

        # ---- core issue (MLP window, per-unit clock + ring) ----
        oldest = ring_u.min()
        slot = ring_u.argmin()
        t_issue = torch.maximum(compute_plane.unit_slice(st.t, cu) + gap,
                                oldest)

        # ---- local memory lookup (the unit's own residency tier) ----
        set_idx = residency.set_index(res_u, page).long()
        present, way, ready_ok = residency.lookup_one(res_u, set_idx,
                                                      page, t_issue)
        is_hit = (present & ready_ok & fl.use_local_mem) | fl.local_only
        inflight_tbl = present & ~ready_ok

        eng = retire_arrivals(eng, t_issue, lpp)

        # ---- engine decision (§4.2) ----
        send_line, send_page = select_granularity(
            eng, page, t_issue, selection_enabled=fl.selection,
            always_both=~fl.selection)
        page_found, pidx = find(eng.page_key, page)
        pending_arrival = torch.where(page_found,
                                      _at(eng.page_arrival, pidx), BIG)
        send_page = (send_page & want_page & ~is_hit & ~inflight_tbl
                     & ~fl.local_only)
        send_line = send_line & fl.move_lines & ~is_hit
        # line-only schemes fetch every miss's line
        line_only = ~fl.move_pages & ~fl.page_free
        send_line = torch.where(line_only, ~is_hit, send_line) \
            & ~fl.local_only

        mc = fabric.place(fcfg, page).long()
        sw = _at(switch, mc)
        t0 = t_issue + sw + trans_lat + remote_lat

        # ---- adaptive §4.1 repartitioning (controller before service;
        # `where`-gated on the adaptive flag, so static schemes carry
        # their seed ratio bit for bit) ----
        bw = torch.clamp(fabric.link_bw_at(st.net.link, mc, t_issue),
                         min=1e-6)
        sb_occ = utilization(eng.sb_key)
        pg_occ = utilization(eng.page_key)
        wire_b = torch.where(fl.compress, page_b / comp_ratio, page_b)
        net_fab = fabric.adapt_ratio_at(
            st.net, mc, t_issue, adaptive=fl.adaptive,
            r_idle=fl.bw_ratio, page_unit=wire_b,
            line_occ=sb_occ, page_occ=pg_occ)
        mem_fab = fabric.adapt_ratio_at(
            st.mem, mc, t_issue, adaptive=fl.adaptive,
            r_idle=fl.bw_ratio, page_unit=page_b,
            line_occ=sb_occ, page_occ=pg_occ)
        ratio = _at(net_fab.ratio, mc)
        line_share, page_share = bandwidth.shares(fl.partition, ratio)
        mem_line_share, _ = bandwidth.shares(fl.partition,
                                             _at(mem_fab.ratio, mc))

        comp_delay = torch.where(fl.compress, comp_lat, zero)
        move_page_physically = send_page & ~fl.page_free

        # ---- remote-memory bus, then the network link priced on the
        # module bank and the requesting unit's NIC (later completion) ----
        mem_fab, lm_done, pm_done = fabric.serve_dual_at(
            mem_fab, mc, partition=fl.partition, now=t_issue,
            line_ready=t0, line_bytes=line_b, line_gate=send_line,
            page_ready=t0, page_bytes=page_b,
            page_gate=move_page_physically)
        (net_fab, nic_fab, ln_done, pn_done, _,
         pn_done_mod) = compute_plane.serve_dual_two_leg(
            net_fab, st.nic, mc, cu, partition=fl.partition, now=t_issue,
            line_ready=lm_done, line_bytes=line_b, line_gate=send_line,
            page_ready=pm_done + comp_delay, page_bytes=wire_b,
            page_gate=move_page_physically, active=nic_on)
        line_arrival = torch.where(send_line, ln_done + sw, BIG)
        # "issued" = transmission start on the MODULE channel (§4.2)
        pn_start = pn_done_mod - wire_b / torch.clamp(bw * page_share,
                                                      min=1e-6)
        page_arrival = torch.where(move_page_physically,
                                   pn_done + sw + comp_delay, BIG)
        # page-free: materializes at the cost of one line access
        free_t = (t_issue + 2 * sw + trans_lat
                  + remote_lat + line_b / bw + line_b / membw)
        page_arrival = torch.where(fl.page_free & send_page, free_t,
                                   page_arrival)

        # ---- serve time ----
        cand = torch.minimum(torch.minimum(line_arrival, page_arrival),
                             pending_arrival)
        untracked = (t_issue + 2 * sw + trans_lat
                     + remote_lat + line_b / (bw * line_share)
                     + line_b / (membw * mem_line_share))
        cand = torch.where(cand >= BIG / 2, untracked, cand)
        done = torch.where(is_hit, t_issue + local_lat, cand)

        # ---- engine bookkeeping (gated insertions) ----
        eng = _gate_tree(send_page, eng,
                         schedule_page(eng, page, pn_start, page_arrival))
        eng = _gate_tree(send_line & fl.move_lines, eng,
                         schedule_line(eng, page, off, line_arrival, lpp))

        # ---- residency update (insert at the policy's victim in the
        # unit's own tier; writeback priced on both endpoints) ----
        do_insert = send_page & fl.use_local_mem
        victim = residency.evict_victim(res_u, set_idx, pol)
        vslot = (set_idx * WAYS + victim).reshape(1)
        evict_page = res_u.page.reshape(-1).gather(0, vslot).reshape(())
        evict_dirty = (res_u.dirty.reshape(-1).gather(0, vslot).reshape(())
                       & (evict_page >= 0))
        wb = do_insert & evict_dirty
        wb_bytes = torch.where(wb, wire_b, zero)
        net_fab, nic_fab, _ = compute_plane.serve_writeback_two_leg(
            net_fab, nic_fab, mc, cu, t_issue, wire_b, gate=wb,
            active=nic_on)

        hit_gate = _cell(is_hit & present)
        res_b = residency.insert(
            _one(res_u), _cell(set_idx), _cell(victim), _cell(page),
            now=_cell(t_issue), ready=_cell(page_arrival), dirty=_cell(wr),
            gate=_cell(do_insert))
        res_b = residency.touch(res_b, _cell(set_idx), _cell(way),
                                _cell(t_issue), pol, gate=hit_gate)
        res_b = residency.mark_dirty(res_b, _cell(set_idx), _cell(way),
                                     _cell(wr), gate=hit_gate)
        res_u = _row(res_b)

        # ---- stats (warmup-gated latency/hit accounting) ----
        stt = st.stats
        warm = stt["i"] >= warm_after
        lat = torch.where(warm, done - t_issue, zero)
        served_line = (~is_hit) & (line_arrival <= torch.minimum(
            page_arrival, pending_arrival))
        # tag-present accesses count as local-memory hits (fig 10)
        stat_hit = is_hit | inflight_tbl
        stats = {
            "i": stt["i"] + 1.0,
            "n": stt["n"] + warm,
            "hits": stt["hits"] + (stat_hit & warm),
            "lat_sum": stt["lat_sum"] + lat,
            "pages_moved": stt["pages_moved"] + move_page_physically,
            "lines_moved": stt["lines_moved"] + send_line,
            "net_bytes": stt["net_bytes"] + wb_bytes
            + torch.where(move_page_physically, wire_b, zero)
            + torch.where(send_line, line_b, zero),
            "wb_bytes": stt["wb_bytes"] + wb_bytes,
            "served_line": stt["served_line"] + served_line,
            "served_page": stt["served_page"] + ((~is_hit) & ~served_line),
            "page_drops": stt["page_drops"] + (
                (~is_hit) & ~send_page & ~page_found & ~inflight_tbl
                & want_page),
            "dirty_evicts": stt["dirty_evicts"] + wb,
            "evictions": stt["evictions"] + (do_insert & (evict_page >= 0)),
        }

        # ---- telemetry plane (static level) ----
        tel = st.tel
        if telcfg is not None and telcfg.enabled:
            # warm-gated end-to-end access latency (hit OR miss)
            tel = telemetry.record_latency(tel, telcfg, done - t_issue,
                                           gate=warm)
            tel = telemetry.record_series(
                tel, telcfg, stt["i"].to(I32),
                torch.stack([
                    fabric.backlog(net_fab, mc, t_issue)[1],
                    ratio,
                    stats["hits"] / torch.clamp(stats["n"], min=1.0),
                    stats["evictions"],
                    stats["wb_bytes"],
                    compute_plane.mean_last(
                        fabric.module_health(net_fab.link, t_issue)),
                ]))

        new_st = SimState(
            t=compute_plane.unit_update(st.t, cu, t_issue),
            ring=compute_plane.unit_update(
                st.ring, cu, ring_u.scatter(0, slot.reshape(1),
                                            done.reshape(1))),
            res=compute_plane.unit_update(st.res, cu, res_u),
            eng=compute_plane.unit_update(st.eng, cu, eng),
            net=net_fab, mem=mem_fab, nic=nic_fab,
            stats=stats, tel=tel,
        )
        return new_st, done

    return step


def _replay(st: SimState, step, trace_arrays) -> SimState:
    """The reference's `lax.scan` over the trace: one step per request,
    the requests' 0-d views taken once."""
    for inp in zip(*(a.unbind(0) for a in trace_arrays)):
        st, _ = step(st, inp)
    return st


def _metrics(final: SimState, net, telcfg) -> dict:
    total_time = torch.maximum(final.ring.max(), final.t.max())
    s = final.stats
    misses = torch.clamp(s["n"] - s["hits"], min=1.0)
    n = torch.clamp(s["n"], min=1.0)
    out = {
        "total_time_ns": total_time,
        "avg_miss_ns": s["lat_sum"] / misses,
        "avg_access_ns": s["lat_sum"] / n,
        "hit_ratio": s["hits"] / n,
        "pages_moved": s["pages_moved"],
        "lines_moved": s["lines_moved"],
        "net_bytes": s["net_bytes"],
        "page_drops": s["page_drops"],
        "bw_util": s["net_bytes"] / torch.clamp(
            total_time * net["bw"][0], min=1e-6),
    }
    if telcfg is not None and telcfg.histogram_on:
        # in-lattice tail read of the warm-gated latency histogram
        p = telemetry.approx_percentiles(final.tel.hist, final.tel.edges,
                                         [0.5, 0.95, 0.99])
        out["p50_access_ns"] = p[0]
        out["p95_access_ns"] = p[1]
        out["p99_access_ns"] = p[2]
    return out


def _simulate_point(cfg, n_pages, telcfg, flags, warm_after, trace_arrays,
                    net, comp_ratio, active_cu, policy):
    """One (scheme, net, active-C, policy) lattice point on tensors: the
    function `simulate_lattice` lifts with vmap. `telcfg` is static."""
    st = _init_state(cfg, n_pages, net, flags.bw_ratio, telcfg)
    step = make_step(flags, cfg, net, comp_ratio, warm_after, active_cu,
                     policy, telcfg)
    return _metrics(_replay(st, step, trace_arrays), net, telcfg)


def _lattice(cfg, n_pages, telcfg, tflags, warm_after, trace_arrays,
             nets, comp_ratio, active_cus, policies):
    """`_simulate_point` over schemes x nets x active-C x policies.

    The reference nests four `jax.vmap`s (schemes, nets, active-C,
    policies; the in_axes of its `_lattice_jit`). Here the four axes are
    flattened into one: each input is laid out along the (S*N*C*P,)
    product in that nesting order (repeated along the axes it does not
    vary on, as the reference's `None` in_axes broadcast it) and one
    `torch.func.vmap` lifts the point. Every lane sees the same operands
    as the nested form, and each op pays one batching level instead of
    four. Returns the metrics dict with (S, N, C, P) leaves."""
    s = tflags.bw_ratio.shape[0]
    n = nets["bw"].shape[0]
    c = active_cus.shape[0]
    p = policies.rrip.shape[0]

    def lay(t, outer, inner):
        """(k, ...) axis leaf -> (outer*k*inner, ...): each entry repeated
        `inner` times, the whole tiled `outer` times."""
        t = t.repeat_interleave(inner, dim=0)
        return t.repeat((outer,) + (1,) * (t.dim() - 1))

    def lay_tree(tree, outer, inner):
        return compute_plane.tree_map(lambda t: lay(t, outer, inner), tree)

    point = partial(_simulate_point, cfg, n_pages, telcfg)
    out = vmap(point, in_dims=(0, None, None, 0, 0, 0, 0))(
        lay_tree(tflags, 1, n * c * p), warm_after, trace_arrays,
        lay_tree(nets, s, c * p), lay(comp_ratio, 1, n * c * p),
        lay(active_cus, s * n, p), lay_tree(policies, s * n * c, 1))
    return {k: v.reshape(s, n, c, p) for k, v in out.items()}


def _trace_arrays(trace: Trace, dev) -> tuple:
    return (torch.as_tensor(np.asarray(trace.page, np.int32), device=dev),
            torch.as_tensor(np.asarray(trace.off, np.int32), device=dev),
            torch.as_tensor(np.asarray(trace.gap, np.float32), device=dev),
            torch.as_tensor(np.asarray(trace.wr, bool), device=dev))


def _net_tensors(net, dev) -> dict:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for k, v in net.items()}


def _lattice_inputs(schemes, cfg, trace, nets, comp_ratio, warm_frac,
                    active_cus, policies, telemetry_cfg, dev):
    """Validate one lattice sweep's inputs and put them on `dev`.

    Returns (tflags, warm_after, arrays, stacked_nets, cr, cus, pols,
    telcfg, squeeze_cu, squeeze_pol, n_cus, n_pols)."""
    schemes = list(schemes)
    if not schemes:
        raise ValueError("simulate_lattice needs at least one scheme")
    squeeze_cu = active_cus is None
    cus = [cfg.num_cu] if squeeze_cu else list(active_cus)
    if not cus or any(c < 1 or c > cfg.num_cu for c in cus):
        raise ValueError(f"active_cus must be a non-empty sequence "
                         f"within [1, num_cu={cfg.num_cu}], got {cus}")
    squeeze_pol = policies is None
    pols = [cfg.default_policy()] if squeeze_pol else list(policies)
    if not pols:
        raise ValueError("simulate_lattice needs at least one policy")
    r = len(trace.page)
    stacked = {k: torch.as_tensor(
        np.stack([np.asarray(n[k], np.float32) for n in nets]), device=dev)
        for k in nets[0]}
    cr = torch.as_tensor(np.broadcast_to(
        np.asarray(comp_ratio, np.float32), (len(schemes),)).copy(),
        device=dev)
    telcfg = _TEL_OFF if telemetry_cfg is None else telemetry_cfg
    # warm_after computed in python float64 (f32(warm_frac) * r can round
    # up past the integer boundary and drop the boundary request)
    return (stack_flags(schemes, dev), _full(warm_frac * r, dev),
            _trace_arrays(trace, dev), stacked, cr,
            torch.as_tensor(np.asarray(cus, np.int32), device=dev),
            residency.stack_policies(pols, dev), telcfg,
            squeeze_cu, squeeze_pol, len(cus), len(pols))


def _nest_lattice(res, n_schemes, n_nets, n_cus, n_pols,
                  squeeze_cu, squeeze_pol):
    """(S, N, C, P)-leaved metrics dict (numpy) -> the documented python
    nesting: [scheme][net] -> dict, with [c] / [policy] levels appended
    when their axes were requested."""
    def cell(i, j, c, p):
        return {k: float(v[i, j, c, p]) for k, v in res.items()}

    def nest(i, j):
        if squeeze_cu and squeeze_pol:
            return cell(i, j, 0, 0)
        if squeeze_pol:
            return [cell(i, j, c, 0) for c in range(n_cus)]
        if squeeze_cu:
            return [cell(i, j, 0, p) for p in range(n_pols)]
        return [[cell(i, j, c, p) for p in range(n_pols)]
                for c in range(n_cus)]

    return [[nest(i, j) for j in range(n_nets)]
            for i in range(n_schemes)]


def simulate_lattice(schemes, cfg: SimConfig, trace: Trace, nets,
                     comp_ratio, warm_frac: float = 0.3,
                     active_cus=None, policies=None,
                     telemetry_cfg: telemetry.TelemetryConfig = None,
                     device=None):
    """Every scheme x every net (x every compute-unit count x every
    replacement policy) over one trace, as one batched replay.

    schemes: SchemeFlags / TraceableFlags (bw-ratio and adaptive variants
    are more entries on the scheme axis). nets: `make_net` dicts sharing
    a knot count. comp_ratio: scalar or one value per scheme.
    active_cus: optional active compute-unit counts, each <= cfg.num_cu.
    policies: optional residency policies (PolicySpec / PolicyFlags /
    names). telemetry_cfg: at level "histogram" and above every cell
    gains warm-gated `p50/p95/p99_access_ns`.

    Result nesting: [scheme][net] -> metrics dict of floats, with a [c]
    level appended when `active_cus` is given and a [policy] level when
    `policies` is given ([scheme][net][c][policy] with both). Runs on the
    card unless `device` says otherwise.
    """
    dev = resolve_device(device)
    schemes = list(schemes)      # may be a generator: list ONCE
    (tflags, warm_after, arrays, stacked, cr, cus, pols, telcfg,
     squeeze_cu, squeeze_pol, n_cus, n_pols) = _lattice_inputs(
        schemes, cfg, trace, nets, comp_ratio, warm_frac, active_cus,
        policies, telemetry_cfg, dev)
    res = _lattice(cfg, trace.n_pages, telcfg, tflags, warm_after, arrays,
                   stacked, cr, cus, pols)
    keys = list(res)
    host = torch.stack([res[k] for k in keys]).cpu().numpy()
    return _nest_lattice(dict(zip(keys, host)), len(schemes), len(nets),
                         n_cus, n_pols, squeeze_cu, squeeze_pol)


def run_trace(scheme_flags, cfg: SimConfig, trace: Trace, net,
              comp_ratio, warm_frac: float = 0.3,
              active_cu: int = None, policy=None,
              telemetry_cfg: telemetry.TelemetryConfig = None,
              device=None) -> SimState:
    """Replay one trace under one scheme/net and return the final
    SimState (residency tier, fabric and NIC banks, link model, adapted
    ratios, byte ledgers, engine buffers, stats) on the device.
    `active_cu` defaults to the full `cfg.num_cu` envelope; `policy` to
    the `SimConfig.fifo` alias; `telemetry_cfg` turns on the telemetry
    plane — the final state's `.tel` then carries the latency histogram
    and the series ring (`SERIES_CHANNELS`) for `runtime.obs` to
    export."""
    dev = resolve_device(device)
    r = len(trace.page)
    fl = as_traceable(scheme_flags, dev)
    nt = _net_tensors(net, dev)
    st = _init_state(cfg, trace.n_pages, nt, fl.bw_ratio, telemetry_cfg)
    cu = cfg.num_cu if active_cu is None else active_cu
    step = make_step(fl, cfg, nt, _full(comp_ratio, dev),
                     _full(warm_frac * r, dev), _full(cu, dev, I32),
                     residency.as_policy(cfg.default_policy()
                                         if policy is None else policy,
                                         dev),
                     telemetry_cfg)
    return _replay(st, step, _trace_arrays(trace, dev))


def simulate_grid(scheme_flags, cfg: SimConfig, trace: Trace,
                  nets, comp_ratio, warm_frac: float = 0.3, device=None):
    """One scheme x one trace over a list of network configs (a lattice of
    scheme-size 1 — kept for paired baseline/variant comparisons)."""
    return simulate_lattice([scheme_flags], cfg, trace, nets, comp_ratio,
                            warm_frac, device=device)[0]


def make_net(p: NetworkParams, num_mc: int = 1, bw_factors=None,
             switches=None, schedule=None) -> dict:
    """Network point: per-module base bandwidths + latencies + the link's
    time-varying schedule (numpy).

    `schedule` is a (sched_t (K,), mult (K,) or (K, M), health (K,) or
    (K, M)) triple — typically `repro_torch.sim.workloads.
    make_link_schedule` output. Default: a K=1 constant, fully-healthy
    schedule. Within one `simulate_lattice` call every net must share a
    knot count so profiles stack on the net axis."""
    bw_factors = bw_factors or [p.bw_factor] * num_mc
    switches = switches or [p.switch_latency_ns] * num_mc
    if schedule is None:
        sched_t = np.zeros((1,), np.float32)
        mult = np.ones((1, num_mc), np.float32)
        health = np.ones((1, num_mc), np.float32)
    else:
        sched_t, mult, health = schedule
        sched_t = np.asarray(sched_t, np.float32)
        to_km = lambda a: np.broadcast_to(
            np.asarray(a, np.float32).reshape((len(sched_t), -1)),
            (len(sched_t), num_mc)).copy()
        mult, health = to_km(mult), to_km(health)
    return {
        "bw": np.asarray([p.dram_bw_gbps / f for f in bw_factors],
                         np.float32),
        "switch": np.asarray(switches, np.float32),
        "membw": np.float32(p.dram_bw_gbps),
        "local_lat": np.float32(p.local_mem_latency_ns),
        "remote_lat": np.float32(p.remote_mem_latency_ns),
        "trans_lat": np.float32(p.translation_latency_ns),
        "sched_t": sched_t,
        "sched_mult": mult,
        "sched_health": health,
    }
