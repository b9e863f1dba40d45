"""The fused residency transaction on the card.

Wrapper of the hand-written CUDA kernel ``csrc/residency_fused.cu``, the
Hopper counterpart of the Pallas kernel
``repro/kernels/residency_fused.py::fused_residency_step``: one CTA per
sequence runs landing compaction, victim choice, the dirty-eviction
writeback list, insert, the landed-row copies, the CAM probe, the hit
gather and the policy touch. The plain version is
``ref.fused_residency_step``; ``ops.residency_fused`` picks between them
by the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.residency import PolicyFlags, ResidencyState
from repro_torch.kernels._build import CudaKernel, check_cuda, ptr, row_bytes

KERNEL = CudaKernel(
    "residency_fused.cu", "residency_fused_launch",
    [ctypes.c_void_p] * 24 + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])

# The staged metadata must fit one block's shared memory on Hopper.
SMEM_LIMIT = 232448


def smem_bytes(sets: int, ways: int, lanes: int, requests: int) -> int:
    """Dynamic shared memory of one CTA (the layout of the .cu file)."""
    n = sets * ways
    return 16 * n + 16 * lanes + 8 * requests + 4 * (32 + 32 + 4) + n


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
    k_land = min(p, n)
    smem = smem_bytes(s_sets, w_ways, k_land, r)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{s_sets}x{w_ways} slots need {smem} B of shared "
                         f"memory; one block has {SMEM_LIMIT}")
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
    params = torch.stack([torch.as_tensor(clock, device=dev).float(),
                          pol.touch_refresh.to(dev).float(),
                          pol.dirty_penalty.to(dev).float(),
                          pol.rrip.to(dev).float()]).contiguous()

    out_page = torch.empty_like(page)
    out_age = torch.empty_like(age)
    out_ready = torch.empty_like(ready)
    out_dirty = torch.empty_like(dirty)
    out_rrpv = torch.empty_like(rrpv)
    evicted = torch.empty((b, k_land), dtype=torch.int32, device=dev)
    n_ev = torch.empty((b,), dtype=torch.float32, device=dev)
    hit = torch.empty((b, r), dtype=torch.bool, device=dev)
    k_local = torch.empty((b, r) + row, dtype=kpool.dtype, device=dev)
    v_local = torch.empty((b, r) + row, dtype=vpool.dtype, device=dev)
    KERNEL.launch(
        ptr(page), ptr(age), ptr(ready), ptr(dirty.view(u8)), ptr(rrpv),
        ptr(landed.view(u8)), ptr(landed_pages), ptr(needed),
        ptr(writes.view(u8)), ptr(params), ptr(kpool), ptr(vpool),
        ptr(remote_k), ptr(remote_v), ptr(out_page), ptr(out_age),
        ptr(out_ready), ptr(out_dirty.view(u8)), ptr(out_rrpv),
        ptr(evicted), ptr(n_ev), ptr(hit.view(u8)), ptr(k_local),
        ptr(v_local), ctypes.c_int(b), ctypes.c_int(s_sets),
        ctypes.c_int(w_ways), ctypes.c_int(p), ctypes.c_int(k_land),
        ctypes.c_int(r), ctypes.c_longlong(remote_k.shape[0]),
        ctypes.c_longlong(nbytes))
    res2 = ResidencyState(page=out_page, age=out_age, ready=out_ready,
                          dirty=out_dirty, rrpv=out_rrpv)
    return res2, kpool, vpool, evicted, n_ev, k_local, v_local, hit
