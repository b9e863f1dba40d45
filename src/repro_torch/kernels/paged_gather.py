"""Paged KV gather on the card: the DaeMon sub-block critical fetch.

Wrapper of the hand-written CUDA kernel ``csrc/paged_gather.cu``, the
Hopper counterpart of the Pallas kernel
``repro/kernels/paged_gather.py::paged_gather``. The plain version is
``ref.paged_gather``; ``ops.paged_gather`` picks between them by the
tensor's device, and ``ops.paged_gather_pair`` gathers the store's K and
V pools in one launch. There is deliberately no kernel for the inverse scatter:
``ref.paged_scatter`` is masked torch indexing (the reference has no
Pallas twin either).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda, ptr, row_bytes

KERNEL = CudaKernel(
    "paged_gather.cu", "paged_gather_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_longlong, ctypes.c_void_p])


def _launch(pools, idx, mask):
    """Check the arguments, allocate the outputs and launch once for the
    one or two equal-shaped `pools`; returns the outputs."""
    for name, pool in zip(("pool", "pool_v"), pools):
        check_cuda(name, pool)
    if len(pools) == 2 and (pools[1].shape != pools[0].shape
                            or pools[1].dtype != pools[0].dtype):
        raise ValueError("the two pools must have one shape and dtype")
    pool = pools[0]
    idx = idx.to(torch.int32).contiguous()
    check_cuda("idx", idx)
    if mask is not None:
        mask = mask.to(torch.bool).contiguous()
        check_cuda("mask", mask)
        if mask.shape != idx.shape:
            raise ValueError("mask must have idx's shape")
    if idx.ndim != 1 or pool.ndim < 1 or pool.shape[0] < 1:
        raise ValueError("need pool (P>=1, ...) and idx (L,)")
    nbytes = row_bytes(pool, 1)
    for other in pools[1:]:
        row_bytes(other, 1)
    outs = [torch.empty((idx.shape[0],) + tuple(pool.shape[1:]),
                        dtype=pool.dtype, device=pool.device)
            for _ in pools]
    if idx.shape[0]:
        second = pools[1] if len(pools) == 2 else None
        KERNEL.launch(ptr(pool), ptr(second), ptr(idx), ptr(mask),
                      ptr(outs[0]), ptr(outs[1] if second is not None
                                        else None),
                      ctypes.c_int(idx.shape[0]),
                      ctypes.c_longlong(pool.shape[0]),
                      ctypes.c_longlong(nbytes))
    return outs


def paged_gather(pool, idx, mask=None):
    """pool (P, *row) on the card, idx (L,) int -> (L, *row) = pool[idx]
    indexed as `ref.paged_gather` indexes (negative from the end, then
    clamped); rows where `mask` (L,) is False are not read and come out
    as zeros. Launches the CUDA kernel or raises."""
    return _launch((pool,), idx, mask)[0]


def paged_gather_pair(pool_k, pool_v, idx, mask=None):
    """`paged_gather` of the same rows from two pools of one shape, in
    one launch: (pool_k[idx], pool_v[idx])."""
    out_k, out_v = _launch((pool_k, pool_v), idx, mask)
    return out_k, out_v
