"""Device-dispatched entries for the port's kernels.

`impl="auto"` launches the CUDA kernel on a CUDA tensor and runs the
plain PyTorch version on a CPU tensor; `"cuda"` always launches the
kernel (and so raises on a CPU tensor); `"ref"` always runs the plain
version — for tests and for holding the kernels against it. There is no
fallback: a kernel that fails to build or launch raises.

Block int8 quantize and dequantize go through their ``torch.library``
custom ops (``kernels.qdq_int8``), which pick the same way by the
tensor's device and which a dry run on fake tensors traces as one op
per call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bdi as _bdi
from repro_torch.kernels import decode_matmul as _dm
from repro_torch.kernels import paged_gather as _pg
from repro_torch.kernels import qdq_int8 as _qdq
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import residency_fused as _rf
from repro_torch.kernels import schedule_fold as _sf
from repro_torch.kernels._build import check_cuda
from repro_torch.kernels.ref import FoldStatics

IMPLS = ("auto", "cuda", "ref")


def _use_kernel(t, impl: str) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "cuda" or (impl == "auto" and t.is_cuda)


def _custom_op(t, name: str, impl: str) -> bool:
    """K3's route: its custom op (the kernel on a CUDA tensor, the plain
    version on a CPU one) unless `impl` is "ref"; "cuda" raises on a CPU
    tensor."""
    if _use_kernel(t, impl) and impl == "cuda":
        check_cuda(name, t)
    return impl != "ref"


def quantize_block_int8(x2d, impl: str = "auto"):
    """(N, B) f32 -> (q (N, B) int8, scale (N, 1) f32), per-row scale."""
    if _custom_op(x2d, "x2d", impl):
        return _qdq.quantize_op(x2d)
    return _ref.quantize_block_int8(x2d)


def dequantize_block_int8(q, scale, out_dtype=torch.float32,
                          impl: str = "auto"):
    """q (N, B) int8 * scale (N, 1) f32 -> (N, B) `out_dtype`."""
    if _custom_op(q, "q", impl):
        return _qdq.dequantize_op(q, scale, out_dtype)
    return _ref.dequantize_block_int8(q, scale, out_dtype)


def bdi_compress(x2d_i32, impl: str = "auto"):
    """(N, B) int32 -> (base (N, 1) int32, deltas (N, B) int8, ok (N, 1)
    int8)."""
    if _use_kernel(x2d_i32, impl):
        return _bdi.bdi_compress(x2d_i32)
    return _ref.bdi_compress(x2d_i32)


def bdi_decompress(base, deltas, ok, raw, impl: str = "auto"):
    """where(ok, base + deltas, raw) (N, B) int32."""
    if _use_kernel(raw, impl):
        return _bdi.bdi_decompress(base, deltas, ok, raw)
    return _ref.bdi_decompress(base, deltas, ok, raw)


def paged_gather(pool, idx, mask=None, impl: str = "auto"):
    """pool[clamp(idx)] (L, *row); rows with mask False are zeros."""
    if _use_kernel(pool, impl):
        return _pg.paged_gather(pool, idx, mask)
    return _ref.paged_gather(pool, idx, mask)


def paged_gather_pair(pool_k, pool_v, idx, mask=None, impl: str = "auto"):
    """(pool_k[clamp(idx)], pool_v[clamp(idx)]), masked as paged_gather;
    one kernel launch for both pools on the card."""
    if _use_kernel(pool_k, impl):
        return _pg.paged_gather_pair(pool_k, pool_v, idx, mask)
    return (_ref.paged_gather(pool_k, idx, mask),
            _ref.paged_gather(pool_v, idx, mask))


def paged_scatter(pool, idx, pages, *, mode=None):
    """Page-plane pool write, in place — masked torch indexing on every
    device (the bulk page plane has no kernel; see paged_gather.py)."""
    return _ref.paged_scatter(pool, idx, pages, mode=mode)


def residency_fused(res, kpool, vpool, remote_k, remote_v, landed,
                    landed_pages, needed_pages, needed_writes, clock, pol,
                    impl: str = "auto"):
    """The fused per-step residency transaction; see
    ref.fused_residency_step for the contract (pools update in place)."""
    fn = (_rf.fused_residency_step if _use_kernel(kpool, impl)
          else _ref.fused_residency_step)
    return fn(res, kpool, vpool, remote_k, remote_v, landed, landed_pages,
              needed_pages, needed_writes, clock, pol)


def decode_matmul(a, w, spec: str, plan=None, impl: str = "auto"):
    """The f32 product of bf16 `a` and `w` by `spec`, one of decode's
    weight-product forms (`decode_matmul.FORMS`); `plan` is
    `decode_matmul.plan(a, w, spec)` where the caller has it. See
    ref.decode_matmul for the contract."""
    fn = (_dm.decode_matmul if _use_kernel(a, impl)
          else _ref.decode_matmul)
    return fn(a, w, spec, plan)


def schedule_fold(eng, fab, needed_pages, needed_offsets, local_hit, clock,
                  statics: FoldStatics, nic=None, cus=None, active=None,
                  impl: str = "auto"):
    """The store's request fold over a step's (B, R) requests; see
    ref.schedule_fold for the contract (nothing updated in place)."""
    fn = (_sf.schedule_fold if _use_kernel(needed_pages, impl)
          else _ref.schedule_fold)
    return fn(eng, fab, needed_pages, needed_offsets, local_hit, clock,
              statics, nic=nic, cus=cus, active=active)
