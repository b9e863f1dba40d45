"""Plain PyTorch versions of the port's kernels.

These are the ground truth the CUDA kernels are held to (bit for bit, on
the card) and what the wrappers in `ops` run on CPU tensors. They follow
``repro.kernels.ref`` op for op, with three PyTorch-side conventions:

* gathers index as jnp does — a negative index counts from the end and
  an index past the table is clamped, as XLA's gather clamps (torch
  indexing would raise instead);
* the pools are updated IN PLACE (`paged_scatter`,
  `fused_residency_step`), as the CUDA kernel updates them. A caller that
  still needs the old pool passes a clone;
* BDI's integer arithmetic wraps at 32 bits. The reference casts to
  ``jnp.int64``, but the repository never enables jax's x64 mode, so the
  cast yields int32 and ``x - base`` wraps; here the difference is taken
  in int64 and wrapped explicitly (`wrap_i32`).

`schedule_fold` is the store's request fold: the plain version of the
kernel ``csrc/schedule_fold.cu``, and what ``daemon_store._schedule``
runs on CPU tensors.

`decode_matmul` is decode's weight product: the plain version of the
kernel ``csrc/decode_matmul.cu``, the operands widened to f32 through
the kernel's own plan.

`decode_attention_paged` is the reference's paged-decode oracle. It has
no kernel, and no serve path calls it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import compute_plane, fabric, residency
from repro_torch.core.engine import (EngineState, _at, find, gate_tree,
                                     schedule_line, schedule_page,
                                     select_granularity, utilization)
from repro_torch.kernels import decode_matmul as _dm

F32 = torch.float32
I32 = torch.int32
BIG = 3.0e38


def quantize_block_int8(x2d):
    """x2d (N, B) float -> (q (N, B) int8, scale (N, 1) f32): per row,
    scale = amax/127 (1.0 where amax is 0) and q = clip(round-half-even(
    x/scale), -127, 127). A NaN quotient gives q = 0, as the reference's
    float-to-int8 convert does (a float NaN cast to int8 is undefined in
    torch)."""
    x = x2d.to(F32)
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, ieee_div(amax, 127.0),
                        torch.ones((), dtype=F32, device=x.device))
    t = torch.clamp(torch.round(x / scale), -127, 127)
    q = torch.nan_to_num(t, nan=0.0).to(torch.int8)
    return q, scale


def ieee_div(x, c: float):
    """x / c rounded once, on every device. PyTorch's CUDA division by a
    Python scalar multiplies by the rounded reciprocal instead (one ulp
    off on some inputs); a divisor tensor on x's device keeps it a true
    division there, as it is on the CPU."""
    return x / torch.full_like(x, c)


def dequantize_block_int8(q, scale, dtype=F32):
    """(q (N, B) int8, scale (N, 1) f32) -> (q * scale) as `dtype`."""
    return (q.to(F32) * scale).to(dtype)


def wrap_i32(x64):
    """int64 tensor -> int32 by two's-complement wraparound."""
    return (((x64 + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(I32)


def bdi_compress(x2d_i32, delta_bits: int = 8):
    """x2d (N, B) int32 -> (base (N, 1) int32, deltas (N, B) int8, ok
    (N, 1) int8): base is each row's first word, delta = x - base
    wrapped to int32, and a row is ok iff every delta fits `delta_bits`
    signed bits; deltas are clipped to that range."""
    base = x2d_i32[:, :1]
    delta = wrap_i32(x2d_i32.long() - base.long())
    lim = 2 ** (delta_bits - 1)
    ok = ((delta >= -lim) & (delta < lim)).all(dim=1, keepdim=True)
    deltas = torch.clamp(delta, -lim, lim - 1).to(torch.int8)
    return base, deltas, ok.to(torch.int8)


def bdi_decompress(base, deltas, ok, raw):
    """Rows with ok != 0 from base + delta (wrapped to int32), the
    others from `raw` (N, B) int32."""
    rec = wrap_i32(base.long() + deltas.long())
    return torch.where(ok.to(torch.bool), rec, raw)


def paged_gather(pool, idx, mask=None):
    """pool (P, *row), idx (L,) int -> (L, *row): pool[idx] as jnp
    indexes — a negative index counts from the end, then the index is
    clamped to [0, P-1].

    `mask` (L,) bool, optional: rows where it is False are not read and
    come out as zeros."""
    p = pool.shape[0]
    idx = idx.long()
    rows = pool[torch.clamp(torch.where(idx < 0, idx + p, idx), 0, p - 1)]
    if mask is None:
        return rows
    keep = mask.reshape((-1,) + (1,) * (rows.ndim - 1))
    return torch.where(keep, rows, torch.zeros((), dtype=rows.dtype,
                                               device=rows.device))


def paged_scatter(pool, idx, pages, *, mode=None):
    """pool[idx] = pages IN PLACE, as jnp's `.at[idx].set` (its default
    and mode="drop" alike): a negative index counts from the end, and a
    lane whose index is still outside [0, P) is dropped — it can never
    clobber a live lane that shares a slot with it. Returns `pool`.

    No lane is selected on the host: a dropped lane rewrites the first
    live lane's value at the first live lane's slot (or, when no lane is
    live, the pool's own value at its clamped slot), so every duplicate
    target receives one value and the scatter stays deterministic. Live
    lanes must target distinct slots."""
    del mode    # jnp drops out-of-bounds lanes under both modes
    p = pool.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + p, idx)
    live = (idx >= 0) & (idx < p)
    clamped = torch.clamp(idx, 0, p - 1)
    first = live.to(I32).argmax().reshape(1)
    any_live = live.any()
    tgt = torch.where(live, idx,
                      torch.where(any_live, idx.index_select(0, first),
                                  clamped))
    lane_shape = (-1,) + (1,) * (pages.ndim - 1)
    val = torch.where(any_live,
                      pages.index_select(0, first).to(pool.dtype),
                      pool[clamped])
    val = torch.where(live.reshape(lane_shape), pages.to(pool.dtype), val)
    pool[tgt] = val
    return pool


def fused_residency_step(res, kpool, vpool, remote_k, remote_v, landed,
                         landed_pages, needed_pages, needed_writes, clock,
                         pol):
    """The whole per-step residency transaction for B sequences.

    Landing (compaction of the arrived in-flight slots, victim selection,
    dirty-eviction enqueue, pool scatter of the arrived remote pages),
    then the CAM lookup (probe gated by `ready <= clock`, pool gather for
    every request, policy touch and dirty propagation on hits).

    `res` leaves (B, S, W); kpool/vpool (B, N, *row) with N = S*W slots,
    updated IN PLACE; landed/landed_pages (B, P); needed_pages /
    needed_writes (B, R); remote_k/remote_v (PR, *row); `clock` 0-d f32;
    `pol` PolicyFlags.

    The reference skips the landing with `lax.cond` when nothing arrived;
    here every lane is masked instead, which gives the same result without
    a host read. Returns (res', kpool, vpool, evicted (B, k) int32 dirty
    victims' page ids (-1 pad), n_evictions (B,) f32, k_local/v_local
    (B, R, *row), local_hit (B, R) bool), k = min(P, N). A miss gathers
    slot (page % S) * W, as the reference does.
    """
    b, s_sets, w_ways = res.page.shape
    n = s_sets * w_ways
    k_land = min(int(landed.shape[1]), n)
    landed = landed.to(torch.bool)

    # ---- landing: lane j <- the j-th landed slot (stable compaction)
    order = torch.sort((~landed).to(I32), dim=1, stable=True).indices
    pick = order[:, :k_land]
    do = landed.gather(1, pick)
    pids = landed_pages.to(I32).gather(1, pick)
    rows = torch.clamp(pids, min=0).reshape(-1)
    page_k = paged_gather(remote_k, rows).to(kpool.dtype)
    page_v = paged_gather(remote_v, rows).to(vpool.dtype)
    sets, vways, ok = residency.landing_victims(res, pids, pol)
    do = do & ok
    vflat = (sets * w_ways + vways).long()
    vict_page = residency._flat(res.page).gather(1, vflat)
    vict_dirty = residency._flat(res.dirty).gather(1, vflat)
    resident = vict_page >= 0
    evicted = torch.where(do & vict_dirty & resident, vict_page, -1)
    n_ev = (do & resident).sum(dim=1).to(F32)
    base = torch.arange(b, device=vflat.device)[:, None] * n
    vslot = torch.where(do, base + vflat, b * n).reshape(-1)  # n: drop
    row = tuple(kpool.shape[2:])
    paged_scatter(kpool.view((b * n,) + row), vslot, page_k, mode="drop")
    paged_scatter(vpool.view((b * n,) + row), vslot, page_v, mode="drop")
    res = residency.insert(res, sets, vways, pids, now=clock, ready=clock,
                           dirty=False, gate=do)

    # ---- CAM probe (after landing: a page landing now hits now)
    present, set_idx, way, ready_ok = residency.lookup(res, needed_pages,
                                                       clock)
    local_hit = present & ready_ok
    slot = (base + (set_idx * w_ways + way)).reshape(-1)
    r = needed_pages.shape[1]
    k_local = paged_gather(kpool.view((b * n,) + row), slot).reshape(
        (b, r) + row)
    v_local = paged_gather(vpool.view((b * n,) + row), slot).reshape(
        (b, r) + row)
    res = residency.touch(res, set_idx, way, clock, pol, gate=local_hit)
    res = residency.mark_dirty(res, set_idx, way, needed_writes.to(
        torch.bool), gate=local_hit)
    return (res, kpool, vpool, evicted.to(I32), n_ev, k_local, v_local,
            local_hit)


class FoldStatics(NamedTuple):
    """The request fold's static choices (the kernel's launch arguments):
    the fabric's modules and placement, the store's §4.2 and §4.1
    switches, the sub-block key stride, the seed line share `r_idle`,
    the nominal page service time in steps, and the wire bytes of one
    critical line and of one page."""
    fabric: fabric.FabricConfig
    selection: bool
    adaptive_ratio: bool
    lines_per_page: int
    r_idle: float
    nominal: float
    line_wire: float
    page_wire: float


def schedule_fold(eng: EngineState, fab: fabric.FabricState, needed_pages,
                  needed_offsets, local_hit, clock, st: FoldStatics,
                  nic=None, cus=None, active=None):
    """Route every miss of a step through the §4.2 selection unit and
    serve its transfers on the shared fabric: sequence order, then
    request order, the fabric (and the NIC bank `nic`) as carry.

    `eng` leaves (B, P) / (B, S); `needed_pages`, `needed_offsets` and
    `local_hit` (B, R); `clock` 0-d f32; with a NIC bank, `cus` (B,) the
    sequences' units and `active` the NIC gate. Nothing is updated in
    place. Returns (eng', fab', nic', line_sent, page_sent, stall, seen):
    the middle three (B, R), `stall` each request's movement-plane delay
    in steps (0 for hits); `seen` lists each sequence's (page_busy,
    ratio) of the fabric after its requests."""
    b, r = needed_pages.shape
    lines, pages, stalls, engs, seen = [], [], [], [], []
    for bi in range(b):
        e = EngineState(*(t[bi] for t in eng))
        for i in range(r):
            pid = needed_pages[bi, i]
            off = needed_offsets[bi, i] % st.lines_per_page
            mc = fabric.place(st.fabric, pid)
            bw = fabric.link_bw_at(fab.link, mc, clock)
            _, page_backlog = fabric.backlog(fab, mc, clock)
            pressure = page_backlog / (page_backlog + st.nominal)
            send_line, send_page = select_granularity(
                e, pid, clock, selection_enabled=st.selection,
                always_both=not st.selection, module_pressure=pressure)
            fab = fabric.adapt_ratio_at(
                fab, mc, clock, adaptive=st.adaptive_ratio,
                r_idle=st.r_idle, page_unit=st.page_wire,
                line_occ=utilization(e.sb_key),
                page_occ=utilization(e.page_key))
            page_share = 1.0 - _at(fab.ratio, mc)
            miss = ~local_hit[bi, i]
            do_page = miss & send_page
            do_line = miss & send_line
            # inflight page the request can ride (lookup BEFORE scheduling)
            inflight, pidx = find(e.page_key, pid)
            pending = torch.where(inflight, _at(e.page_arrival, pidx), BIG)
            serve = dict(partition=True, now=clock,
                         line_ready=clock, line_bytes=st.line_wire,
                         line_gate=do_line, page_ready=clock,
                         page_bytes=st.page_wire, page_gate=do_page)
            if nic is None:
                fab, line_done, page_done = fabric.serve_dual_at(
                    fab, mc, **serve)
                page_done_mod = page_done
            else:
                fab, nic, line_done, page_done, _, page_done_mod = \
                    compute_plane.serve_dual_two_leg(
                        fab, nic, mc, cus[bi], active=active, **serve)
            # issue = transmission start on the module channel (§4.2)
            page_start = page_done_mod - st.page_wire / torch.clamp(
                bw * page_share, min=1e-6)
            e = gate_tree(do_page, e,
                          schedule_page(e, pid, page_start, page_done))
            e = gate_tree(do_line, e,
                          schedule_line(e, pid, off, line_done,
                                        st.lines_per_page))
            served_at = torch.minimum(
                torch.where(do_line, line_done, BIG),
                torch.minimum(torch.where(do_page, page_done, BIG),
                              pending))
            served_at = torch.where(served_at >= BIG / 2,
                                    clock + st.nominal, served_at)
            stall = torch.where(miss, torch.clamp(served_at - clock,
                                                  min=0.0), 0.0)
            lines.append(do_line)
            pages.append(do_page)
            stalls.append(stall)
        engs.append(e)
        seen.append((fab.page_busy, fab.ratio))
    eng = EngineState(*(torch.stack(leaves) for leaves in zip(*engs)))
    shape = (b, r)
    return (eng, fab, nic, torch.stack(lines).reshape(shape),
            torch.stack(pages).reshape(shape),
            torch.stack(stalls).reshape(shape), seen)


def decode_matmul(a, w, spec: str, p=None):
    """The f32 product of bf16 `a` and `w` by `spec` (one of
    `decode_matmul.FORMS`), read through the kernel's plan `p`: the
    operands are the plan's strided views (E, M, K1, K2) and (E, K1, K2,
    N) or (E, N, K1, K2), widened to f32, and the product is written
    through the plan's output strides. Summed in the order
    ``torch.einsum`` takes the spec's contraction letters, it equals
    `layers.dot`'s widened einsum bit for bit. Raises where `plan` gives
    None."""
    if p is None:
        p = _dm.require_plan(a, w, spec)
    a4 = a.as_strided((p.e, p.m, p.k1, p.k2), p.a_strides)
    w4 = w.as_strided((p.e, p.n, p.k1, p.k2) if p.nk
                      else (p.e, p.k1, p.k2, p.n), p.w_strides)
    out = torch.empty(p.out_shape, dtype=F32, device=a.device)
    o3 = out.as_strided((p.e, p.m, p.n), p.out_strides + (1,))
    k1, k2 = "ji" if p.k2_first else "ij"
    wk = f"en{k1}{k2}" if p.nk else f"e{k1}{k2}n"
    o3.copy_(torch.einsum(f"em{k1}{k2},{wk}->emn", a4.to(F32), w4.to(F32)))
    return out


def decode_attention_paged(q, kpages, vpages, page_table, lengths):
    """Paged flash-decode oracle.

    q: (B, NH, D); kpages/vpages: (P, page, KV, D) pool; page_table:
    (B, MAXP) int32 page ids (-1 pad); lengths: (B,) tokens. Returns
    (B, NH, D): each sequence's pages gathered, the KV heads broadcast
    to NH, and a softmax over the first `lengths` tokens, in f32."""
    b, nh, d = q.shape
    _, page, kvh, _ = kpages.shape
    maxp = page_table.shape[1]
    group = nh // kvh
    tbl = torch.clamp(page_table.long(), min=0)
    k = kpages[tbl].reshape(b, maxp * page, kvh, d)
    v = vpages[tbl].reshape(b, maxp * page, kvh, d)
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bnd,btnd->bnt", q.to(F32), k.to(F32))
    s = s / torch.sqrt(torch.tensor(d, dtype=F32, device=q.device))
    pos = torch.arange(maxp * page, device=q.device)
    mask = pos[None, :] < lengths.to(q.device)[:, None]
    s = torch.where(mask[:, None, :], s, torch.tensor(-1e30, dtype=F32,
                                                      device=q.device))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bnt,btnd->bnd", w, v.to(F32)).to(q.dtype)
