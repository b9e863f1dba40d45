"""Link compression for tensor movement (DaeMon §4.4, adapted to tensors).

PyTorch counterpart of ``repro.core.compression``. Blockwise int8 and
int4 quantization with one f32 scale per block of `block` values (the
ratio-oriented compressor for float tensors, with error feedback for
gradient links), and BDI (base + delta-immediate) for exact integer
words.

`quantize_block_int8` / `dequantize_block_int8` pad and reshape a tensor
into (N, block) rows and call ``kernels.ops``: on a CUDA tensor that is
the hand-written kernel of ``csrc/qdq_int8.cu``, on a CPU tensor its
plain version. The int4 and block-BDI functions are plain torch. BDI's
differences wrap at 32 bits, as the reference's do (see
``kernels.ref.wrap_i32``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as _kref

F32 = torch.float32


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _blocked(x, block: int):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block), pad


def quantize_block_int8(x, block: int = 256
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-block int8 quantization. Returns (q (N, block) int8,
    scales (N,) f32)."""
    xb, _ = _blocked(x.to(F32), block)
    q, scale = ops.quantize_block_int8(xb.contiguous())
    return q, scale[:, 0]


def dequantize_block_int8(q, scale, shape, block: int = 256):
    """(q, scales) -> the f32 tensor of `shape` (padding dropped)."""
    x = ops.dequantize_block_int8(q, scale[:, None], F32)
    return x.reshape(-1)[:_numel(shape)].reshape(shape)


def quantize_block_int4(x, block: int = 256):
    """Packed int4 (two nibbles per byte, low nibble first). Returns
    (packed (N, block/2) uint8, scales (N,) f32)."""
    xb, _ = _blocked(x.to(F32), block)
    amax = xb.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, _kref.ieee_div(amax, 7.0),
                        torch.ones((), dtype=F32, device=xb.device))
    q = torch.clamp(torch.round(xb / scale), -7, 7).to(torch.int32) + 8
    packed = (q[:, 0::2] | (q[:, 1::2] << 4)).to(torch.uint8)
    return packed, scale[:, 0]


def dequantize_block_int4(packed, scale, shape, block: int = 256):
    p = packed.to(torch.int32)
    lo = (p & 0xF) - 8
    hi = ((p >> 4) & 0xF) - 8
    q = torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)
    x = q.to(F32) * scale[:, None]
    return x.reshape(-1)[:_numel(shape)].reshape(shape)


# --------------------------------------------------------------------------
# BDI (base + delta-immediate) — exact compression for integer-like pages
# --------------------------------------------------------------------------
def bdi_compress_block(x_i32, delta_bits: int = 8):
    """One block of int32 words -> (base (), deltas (n,) int8, ok ()).

    A block compresses iff every word fits base + a `delta_bits` delta,
    the delta taken with int32 wraparound; callers store ok=False blocks
    raw."""
    base = x_i32[0]
    delta = _kref.wrap_i32(x_i32.long() - base.long())
    lim = 2 ** (delta_bits - 1)
    ok = ((delta >= -lim) & (delta < lim)).all()
    deltas = torch.clamp(delta, -lim, lim - 1).to(torch.int8)
    return base, deltas, ok


def bdi_decompress_block(base, deltas):
    return _kref.wrap_i32(base.long() + deltas.long())


def compression_ratio_int8(shape, block: int = 256) -> float:
    """Wire ratio f32 -> (int8 + f32 scale/block)."""
    n = _numel(shape)
    nblocks = -(-n // block)
    return (4.0 * n) / (n + 4.0 * nblocks)


# --------------------------------------------------------------------------
# error feedback for gradient links
# --------------------------------------------------------------------------
def ef_compress(g, residual, block: int = 256):
    """Error-feedback int8 compression: q(g + residual), new residual."""
    target = g.to(F32) + residual
    q, scale = quantize_block_int8(target, block)
    deq = dequantize_block_int8(q, scale, target.shape, block)
    return q, scale, target - deq
