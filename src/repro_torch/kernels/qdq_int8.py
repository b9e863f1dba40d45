"""Block int8 quantize and dequantize on the card.

Wrappers of the hand-written CUDA kernels in ``csrc/qdq_int8.cu``, the
Hopper counterparts of the Pallas kernels
``repro/kernels/qdq_int8.py::quantize_block_int8`` and
``::dequantize_block_int8``. The plain versions are
``ref.quantize_block_int8`` / ``ref.dequantize_block_int8``; ``ops`` picks
between them by the tensor's device. Unlike the Pallas kernels, any
number of rows is taken; the block width B must be one of `BLOCKS`.

`quantize_op` and `dequantize_op` are the same two functions as
``torch.library`` custom ops (``repro_torch::quantize_block_int8`` and
``repro_torch::dequantize_block_int8``): on a CUDA tensor they launch the
kernel through the wrappers below, on a CPU tensor they run the plain
version, and on a fake tensor (the dry run) their fake implementation
gives the output shapes, so a traced step sees each call as one op.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda, ptr

BLOCKS = (128, 256, 512, 1024)
QUANT = CudaKernel("qdq_int8.cu", "quantize_block_int8_launch",
                   [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p])
DEQUANT = CudaKernel("qdq_int8.cu", "dequantize_block_int8_launch",
                     [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                              ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p])
KERNELS = (QUANT, DEQUANT)
OUT_DTYPES = (torch.float32, torch.bfloat16)


def _check_block(shape):
    if len(shape) != 2 or shape[1] not in BLOCKS:
        raise ValueError(f"need (N, B) rows with B in {BLOCKS}, got "
                         f"{tuple(shape)}")


def quantize_block_int8(x2d):
    """x2d (N, B) f32 on the card -> (q (N, B) int8, scale (N, 1) f32),
    as `ref.quantize_block_int8`. Launches the kernel or raises."""
    check_cuda("x2d", x2d, torch.float32)
    _check_block(x2d.shape)
    if x2d.data_ptr() % 16:
        raise ValueError("x2d must start at a 16-byte-aligned address")
    n, b = x2d.shape
    q = torch.empty((n, b), dtype=torch.int8, device=x2d.device)
    scale = torch.empty((n, 1), dtype=torch.float32, device=x2d.device)
    if n:
        QUANT.launch(ptr(x2d), ptr(q), ptr(scale), ctypes.c_longlong(n),
                     ctypes.c_int(b))
    return q, scale


def dequantize_block_int8(q, scale, dtype=torch.float32):
    """(q (N, B) int8, scale (N, 1) f32) on the card -> q * scale as
    `dtype` (f32 or bf16), as `ref.dequantize_block_int8`. Launches the
    kernel or raises."""
    check_cuda("q", q, torch.int8)
    check_cuda("scale", scale, torch.float32)
    _check_block(q.shape)
    n, b = q.shape
    if tuple(scale.shape) != (n, 1):
        raise ValueError(f"scale must be {(n, 1)}, got {tuple(scale.shape)}")
    if dtype not in OUT_DTYPES:
        raise ValueError(f"dtype must be one of {OUT_DTYPES}, got {dtype}")
    if q.data_ptr() % 4:
        raise ValueError("q must start at a 4-byte-aligned address")
    out = torch.empty((n, b), dtype=dtype, device=q.device)
    if n:
        DEQUANT.launch(ptr(q), ptr(scale), ptr(out), ctypes.c_longlong(n),
                       ctypes.c_int(b), ctypes.c_int(dtype == torch.bfloat16))
    return out


@torch.library.custom_op("repro_torch::quantize_block_int8", mutates_args=(),
                         schema="(Tensor x2d) -> (Tensor, Tensor)")
def quantize_op(x2d):
    """`quantize_block_int8` on a CUDA tensor, its plain version on a CPU
    tensor."""
    if x2d.is_cuda:
        return quantize_block_int8(x2d)
    from repro_torch.kernels import ref
    return ref.quantize_block_int8(x2d)


@quantize_op.register_fake
def _(x2d):
    n, b = x2d.shape
    return (x2d.new_empty((n, b), dtype=torch.int8),
            x2d.new_empty((n, 1), dtype=torch.float32))


@torch.library.custom_op("repro_torch::dequantize_block_int8",
                         mutates_args=(),
                         schema="(Tensor q, Tensor scale, ScalarType dtype)"
                                " -> Tensor")
def dequantize_op(q, scale, dtype):
    """`dequantize_block_int8` on a CUDA tensor, its plain version on a
    CPU tensor."""
    if q.is_cuda:
        return dequantize_block_int8(q, scale, dtype)
    from repro_torch.kernels import ref
    return ref.dequantize_block_int8(q, scale, dtype)


@dequantize_op.register_fake
def _(q, scale, dtype):
    return q.new_empty(q.shape, dtype=dtype)
