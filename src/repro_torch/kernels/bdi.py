"""BDI row compression on the card.

Wrappers of the hand-written CUDA kernels in ``csrc/bdi.cu``, the Hopper
counterparts of the Pallas kernels ``repro/kernels/bdi.py::bdi_compress``
and ``::bdi_decompress``. The plain versions are ``ref.bdi_compress`` /
``ref.bdi_decompress``; ``ops`` picks between them by the tensor's
device. As in the reference package, no path of the system calls them:
``ops.bdi_compress`` / ``ops.bdi_decompress`` are their only entries.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda, ptr

BLOCKS = (128, 256, 512, 1024)
COMPRESS = CudaKernel("bdi.cu", "bdi_compress_launch",
                      [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p])
DECOMPRESS = CudaKernel("bdi.cu", "bdi_decompress_launch",
                        [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                                 ctypes.c_int,
                                                 ctypes.c_void_p])
KERNELS = (COMPRESS, DECOMPRESS)


def _check_rows(name, t, dtype):
    check_cuda(name, t, dtype)
    if t.ndim != 2 or t.shape[1] not in BLOCKS:
        raise ValueError(f"{name}: need (N, B) rows with B in {BLOCKS}, got "
                         f"{tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start at a 16-byte-aligned address")


def bdi_compress(x2d_i32):
    """x2d (N, B) int32 on the card -> (base (N, 1) int32, deltas (N, B)
    int8, ok (N, 1) int8), as `ref.bdi_compress`. Launches the kernel or
    raises."""
    _check_rows("x2d_i32", x2d_i32, torch.int32)
    n, b = x2d_i32.shape
    dev = x2d_i32.device
    base = torch.empty((n, 1), dtype=torch.int32, device=dev)
    deltas = torch.empty((n, b), dtype=torch.int8, device=dev)
    ok = torch.empty((n, 1), dtype=torch.int8, device=dev)
    if n:
        COMPRESS.launch(ptr(x2d_i32), ptr(base), ptr(deltas), ptr(ok),
                        ctypes.c_longlong(n), ctypes.c_int(b))
    return base, deltas, ok


def bdi_decompress(base, deltas, ok, raw):
    """Rows with ok != 0 from base + delta (wrapped to int32), the others
    from `raw`, as `ref.bdi_decompress`. Launches the kernel or raises."""
    _check_rows("raw", raw, torch.int32)
    n, b = raw.shape
    check_cuda("base", base, torch.int32)
    check_cuda("deltas", deltas, torch.int8)
    check_cuda("ok", ok, torch.int8)
    if (tuple(base.shape) != (n, 1) or tuple(ok.shape) != (n, 1)
            or tuple(deltas.shape) != (n, b)):
        raise ValueError(f"need base/ok (N, 1) and deltas (N, B) for raw "
                         f"{(n, b)}")
    if deltas.data_ptr() % 4:
        raise ValueError("deltas must start at a 4-byte-aligned address")
    out = torch.empty((n, b), dtype=torch.int32, device=raw.device)
    if n:
        DECOMPRESS.launch(ptr(base), ptr(deltas), ptr(ok), ptr(raw),
                          ptr(out), ctypes.c_longlong(n), ctypes.c_int(b))
    return out
