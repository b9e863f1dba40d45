"""The fused residency transaction on the card.

Wrapper of the hand-written CUDA kernel ``csrc/residency_fused.cu``, the
Hopper counterpart of the Pallas kernel
``repro/kernels/residency_fused.py::fused_residency_step``: several
blocks per sequence run landing compaction, victim choice, the
dirty-eviction writeback list, insert, the landed-row copies, the CAM
probe, the hit gather and the policy touch. `launch_geometry` lays the
launch out (blocks per sequence, touched-set bound, each rank's share of
the copies, shared memory). The plain version is
``ref.fused_residency_step``; ``ops.residency_fused`` picks between them
by the tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.residency import PolicyFlags, ResidencyState
from repro_torch.kernels._build import CudaKernel, check_cuda, ptr, row_bytes

KERNEL = CudaKernel(
    "residency_fused.cu", "residency_fused_launch",
    [ctypes.c_void_p] * 27 + [ctypes.c_int] * 10
    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])

SMEM_LIMIT = 232448         # dynamic shared memory of one Hopper block
SM_SMEM = 233472            # shared memory of one SM
NUM_SMS = 132               # H100 SXM
THREADS = 256               # kThreads of the .cu file
WARPS = THREADS // 32
RESIDENT_PER_SM = 2         # blocks per SM the grid is sized for
MAX_BLOCKS = 32             # blocks per sequence


class Geometry(NamedTuple):
    """How one launch is laid out: `blocks` per sequence, each staging at
    most `touched` sets and deciding; rank 0 writes the decisions out,
    ranks 1..C-1 each copy `sets_per_cta` sets of untouched metadata and
    `cols_per_cta` 16-byte columns of each row copy."""
    blocks: int
    grid: int
    lanes: int
    touched: int
    sets_per_cta: int
    cols_per_cta: int
    smem: int


def smem_bytes(sets: int, ways: int, inflight: int, lanes: int,
               requests: int, touched: int) -> int:
    """Dynamic shared memory of one block: `smem_layout` of the .cu file,
    each piece rounded up to 16 bytes."""
    tw = touched * ways
    nwords = -(-sets // 32)
    pieces = ([4 * tw] * 6 + [4 * lanes] * 7 + [4 * touched] * 3
              + [4 * nwords] * 2 + [4 * requests] * 3
              + [4 * (WARPS + 1)] * 2 + [16, 16, 4 * inflight, 4 * requests,
                                         inflight, requests, tw])
    return sum(-(-x // 16) * 16 for x in pieces)


def launch_geometry(batch: int, sets: int, ways: int, inflight: int,
                    requests: int, row_bytes: int) -> Geometry:
    """The launch for B sequences of (sets x ways) slots, `inflight`
    in-flight lanes, `requests` requests and rows of `row_bytes`. The
    touched sets are bounded by the landed lanes plus the requests. Each
    sequence gets as many blocks (2 to MAX_BLOCKS) as keep the grid
    resident at once, at RESIDENT_PER_SM blocks per SM or fewer where
    shared memory allows fewer."""
    lanes = min(inflight, sets * ways)
    touched = min(sets, inflight + requests)
    vecs = row_bytes // 16
    smem = smem_bytes(sets, ways, inflight, lanes, requests, touched)
    resident = min(RESIDENT_PER_SM, SM_SMEM // (smem + 1024)) * NUM_SMS
    blocks = max(2, min(MAX_BLOCKS, resident // max(batch, 1)))
    return Geometry(
        blocks=blocks, grid=batch * blocks, lanes=lanes, touched=touched,
        sets_per_cta=-(-sets // (blocks - 1)),
        cols_per_cta=-(-vecs // (blocks - 1)), smem=smem)


def fused_residency_step(res: ResidencyState, kpool, vpool, remote_k,
                         remote_v, landed, landed_pages, needed_pages,
                         needed_writes, clock, pol: PolicyFlags):
    """Same contract as `ref.fused_residency_step`, on CUDA tensors:
    kpool and vpool are updated IN PLACE and returned; the metadata comes
    back in new tensors. Launches the kernel or raises."""
    b, s_sets, w_ways = res.page.shape
    n = s_sets * w_ways
    p = int(landed.shape[1])
    r = int(needed_pages.shape[1])
    row = tuple(kpool.shape[2:])
    for name, pool in (("kpool", kpool), ("vpool", vpool)):
        check_cuda(name, pool)
        if tuple(pool.shape) != (b, n) + row:
            raise ValueError(f"{name} must be {(b, n) + row}")
    for name, rem in (("remote_k", remote_k), ("remote_v", remote_v)):
        check_cuda(name, rem, kpool.dtype)
        if tuple(rem.shape[1:]) != row or rem.shape[0] < 1:
            raise ValueError(f"{name} rows must be {row}")
    if remote_k.shape[0] != remote_v.shape[0]:
        raise ValueError("remote_k and remote_v must have equal rows")
    nbytes = row_bytes(kpool, 2)
    row_bytes(vpool, 2)
    row_bytes(remote_k, 1)
    row_bytes(remote_v, 1)
    geo = launch_geometry(b, s_sets, w_ways, p, r, nbytes)
    if geo.smem > SMEM_LIMIT:
        raise ValueError(f"{s_sets}x{w_ways} slots need {geo.smem} B of "
                         f"shared memory; one block has {SMEM_LIMIT}")

    dev = kpool.device
    u8 = torch.uint8

    def meta(t, dtype):
        t = t.contiguous()
        check_cuda("residency", t, dtype)
        return t

    page = meta(res.page, torch.int32)
    age = meta(res.age, torch.float32)
    ready = meta(res.ready, torch.float32)
    dirty = meta(res.dirty, torch.bool)
    rrpv = meta(res.rrpv, torch.float32)
    landed = landed.to(torch.bool).contiguous()
    landed_pages = landed_pages.to(torch.int32).contiguous()
    needed = needed_pages.to(torch.int32).contiguous()
    writes = needed_writes.to(torch.bool).contiguous()
    for name, t, shape in (("landed", landed, (b, p)),
                           ("landed_pages", landed_pages, (b, p)),
                           ("needed_pages", needed, (b, r)),
                           ("needed_writes", writes, (b, r))):
        check_cuda(name, t)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}")
    # the scalars are read by the kernel where they lie: no stack, and no
    # launch when they already are 0-d tensors of these types on the card
    clock = torch.as_tensor(clock, dtype=torch.float32, device=dev)
    scalars = (clock, pol.touch_refresh.to(dev, torch.bool),
               pol.dirty_penalty.to(dev, torch.float32),
               pol.rrip.to(dev, torch.bool))
    for t in scalars:
        if t.numel() != 1:
            raise ValueError("clock and the policy flags must be scalars")

    out_page = torch.empty_like(page)
    out_age = torch.empty_like(age)
    out_ready = torch.empty_like(ready)
    out_dirty = torch.empty_like(dirty)
    out_rrpv = torch.empty_like(rrpv)
    evicted = torch.empty((b, geo.lanes), dtype=torch.int32, device=dev)
    n_ev = torch.empty((b,), dtype=torch.float32, device=dev)
    hit = torch.empty((b, r), dtype=torch.bool, device=dev)
    k_local = torch.empty((b, r) + row, dtype=kpool.dtype, device=dev)
    v_local = torch.empty((b, r) + row, dtype=vpool.dtype, device=dev)
    KERNEL.launch(
        ptr(page), ptr(age), ptr(ready), ptr(dirty.view(u8)), ptr(rrpv),
        ptr(landed.view(u8)), ptr(landed_pages), ptr(needed),
        ptr(writes.view(u8)), *(ptr(t) for t in scalars), ptr(kpool),
        ptr(vpool), ptr(remote_k), ptr(remote_v), ptr(out_page),
        ptr(out_age), ptr(out_ready), ptr(out_dirty.view(u8)),
        ptr(out_rrpv), ptr(evicted), ptr(n_ev), ptr(hit.view(u8)),
        ptr(k_local), ptr(v_local), *(ctypes.c_int(x) for x in (
            b, s_sets, w_ways, p, geo.lanes, r, geo.touched, geo.blocks,
            geo.sets_per_cta, geo.cols_per_cta)),
        ctypes.c_longlong(remote_k.shape[0]), ctypes.c_longlong(nbytes))
    res2 = ResidencyState(page=out_page, age=out_age, ready=out_ready,
                          dirty=out_dirty, rrpv=out_rrpv)
    return res2, kpool, vpool, evicted, n_ev, k_local, v_local, hit
