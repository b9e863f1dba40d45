"""Paged KV gather on the card: the DaeMon sub-block critical fetch.

Wrapper of the hand-written CUDA kernel ``csrc/paged_gather.cu``, the
Hopper counterpart of the Pallas kernel
``repro/kernels/paged_gather.py::paged_gather``. The plain version is
``ref.paged_gather``; ``ops.paged_gather`` picks between them by the
tensor's device. There is deliberately no kernel for the inverse scatter:
``ref.paged_scatter`` is masked torch indexing (the reference has no
Pallas twin either).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda, ptr, row_bytes

KERNEL = CudaKernel(
    "paged_gather.cu", "paged_gather_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                             ctypes.c_longlong, ctypes.c_void_p])


def paged_gather(pool, idx, mask=None):
    """pool (P, *row) on the card, idx (L,) int -> (L, *row) = pool[idx]
    indexed as `ref.paged_gather` indexes (negative from the end, then
    clamped); rows where `mask` (L,) is False are not read and come out
    as zeros. Launches the CUDA kernel or raises."""
    check_cuda("pool", pool)
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
    out = torch.empty((idx.shape[0],) + tuple(pool.shape[1:]),
                      dtype=pool.dtype, device=pool.device)
    if idx.shape[0]:
        KERNEL.launch(ptr(pool), ptr(idx), ptr(mask), ptr(out),
                      ctypes.c_int(idx.shape[0]),
                      ctypes.c_longlong(pool.shape[0]),
                      ctypes.c_longlong(nbytes))
    return out
