"""The store's request fold on the card.

Wrapper of the hand-written CUDA kernel ``csrc/schedule_fold.cu``: every
request of a decode step routed through the §4.2 selection unit and
priced on the shared fabric (and on the NIC bank of a replicated store),
in sequence order and then request order, in one launch. The reference
runs this fold as a ``lax.scan`` inside its step
(``repro/core/daemon_store.py``, ``_schedule``); it has no Pallas kernel.
The plain version is ``ref.schedule_fold``; ``ops.schedule_fold`` picks
between them by the tensors' device.

The launch takes its pointers, integers and floats as three host arrays
(`_PTRS` names the pointers in order), which the C launcher copies into
the kernel's arguments. Every output is a fresh tensor: the kernel copies
the inputs into them and updates only the copies.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bandwidth, fabric
from repro_torch.core.engine import EngineState
from repro_torch.core.fabric import FabricState
from repro_torch.kernels._build import CudaKernel, check_cuda
from repro_torch.kernels.ref import BIG, FoldStatics

KERNEL = CudaKernel("schedule_fold.cu", "schedule_fold_launch",
                    [ctypes.c_void_p, ctypes.c_int] * 3)

# The bank leaves the fold carries, in the .cu file's `Leaf` order (every
# FabricState field but the link).
LEAVES = FabricState._fields[:-1]
LINK = ("bw", "sched_t", "sched_mult", "health")
# fabric.adapt_ratio_at's default controller gain, which the fold uses
GAIN = 0.25
ENGINE_DTYPES = (torch.int32, torch.int8, torch.float32, torch.float32,
                 torch.int8, torch.int32, torch.float32)

# the pointer array's layout; the .cu file reads it in this order
_PTRS = (tuple(f"eng.{f}" for f in EngineState._fields)
         + tuple(f"out.eng.{f}" for f in EngineState._fields)
         + tuple(f"fab.{f}" for f in LEAVES + LINK)
         + tuple(f"out.fab.{f}" for f in LEAVES)
         + tuple(f"nic.{f}" for f in LEAVES + LINK)
         + tuple(f"out.nic.{f}" for f in LEAVES)
         + ("needed_pages", "needed_offsets", "local_hit", "clock", "cus",
            "active", "line_sent", "page_sent", "stalls", "seen_busy",
            "seen_ratio"))


def _check(name, t, dtype, shape):
    check_cuda(name, t, dtype)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _bank(name, bank: FabricState, units: int, ptrs: dict) -> FabricState:
    """Check one bank's leaves and link, enter their pointers and return
    the fresh output bank (its link is the input's, which no step
    writes)."""
    knots = bank.link.sched_t.numel()
    if knots < 1:
        raise ValueError(f"{name}.link.sched_t must be (K,), K >= 1")
    for f in LEAVES:
        t = getattr(bank, f)
        _check(f"{name}.{f}", t, torch.float32, (units,))
        ptrs[f"{name}.{f}"] = t
    for f, shape in zip(LINK, ((units,), (knots,), (knots, units),
                               (knots, units))):
        t = getattr(bank.link, f)
        _check(f"{name}.link.{f}", t, torch.float32, shape)
        ptrs[f"{name}.{f}"] = t
    out = bank._replace(**{f: torch.empty_like(getattr(bank, f))
                           for f in LEAVES})
    for f in LEAVES:
        ptrs[f"out.{name}.{f}"] = getattr(out, f)
    return out


def schedule_fold(eng: EngineState, fab: FabricState, needed_pages,
                  needed_offsets, local_hit, clock, st: FoldStatics,
                  nic=None, cus=None, active=None):
    """Same contract as `ref.schedule_fold`, on CUDA tensors: one kernel
    launch, no host read, no synchronise. Raises on a tensor that is not
    a contiguous CUDA tensor of the expected dtype and shape."""
    b, r = needed_pages.shape
    p = eng.page_key.shape[-1]
    s = eng.sb_key.shape[-1]
    m = st.fabric.num_modules
    dev = needed_pages.device
    ptrs = {}
    for f, dtype in zip(EngineState._fields, ENGINE_DTYPES):
        t = getattr(eng, f)
        _check(f"eng.{f}", t, dtype, (b, s if f.startswith("sb_") else p))
        ptrs[f"eng.{f}"] = t
    out_eng = EngineState(*(torch.empty_like(t) for t in eng))
    for f in EngineState._fields:
        ptrs[f"out.eng.{f}"] = getattr(out_eng, f)
    out_fab = _bank("fab", fab, m, ptrs)
    _check("needed_pages", needed_pages, torch.int32, (b, r))
    _check("needed_offsets", needed_offsets, torch.int32, (b, r))
    _check("local_hit", local_hit, torch.bool, (b, r))
    _check("clock", clock, torch.float32, ())
    ptrs.update(needed_pages=needed_pages, needed_offsets=needed_offsets,
                local_hit=local_hit, clock=clock)
    units, nic_knots, out_nic = 0, 0, None
    if nic is not None:
        units = nic.line_busy.shape[0]
        out_nic = _bank("nic", nic, units, ptrs)
        nic_knots = nic.link.sched_t.shape[0]
        _check("cus", cus, torch.int64, (b,))
        _check("active", active, torch.bool, ())
        ptrs.update(cus=cus, active=active)
    line_sent = torch.empty((b, r), dtype=torch.bool, device=dev)
    page_sent = torch.empty((b, r), dtype=torch.bool, device=dev)
    stalls = torch.empty((b, r), dtype=torch.float32, device=dev)
    seen_busy = torch.empty((b, m), dtype=torch.float32, device=dev)
    seen_ratio = torch.empty((b, m), dtype=torch.float32, device=dev)
    ptrs.update(line_sent=line_sent, page_sent=page_sent, stalls=stalls,
                seen_busy=seen_busy, seen_ratio=seen_ratio)

    addrs = [ptrs[k].data_ptr() if k in ptrs else None for k in _PTRS]
    ints = (b, r, p, s, m, fab.link.sched_t.shape[0], units, nic_knots,
            st.lines_per_page, fabric.PLACEMENTS.index(st.fabric.placement),
            st.fabric.affinity_block, int(st.selection),
            int(st.adaptive_ratio), int(nic is not None))
    # each float rounded to f32 as torch rounds a Python scalar operand
    floats = (st.nominal, st.line_wire, st.page_wire, st.r_idle,
              fabric.EMA_ALPHA, 1 - fabric.EMA_ALPHA, GAIN,
              bandwidth.RATIO_MIN, bandwidth.RATIO_MAX, BIG, BIG / 2)
    c_ptrs = (ctypes.c_void_p * len(addrs))(*addrs)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_floats = (ctypes.c_float * len(floats))(*floats)
    KERNEL.launch(ctypes.cast(c_ptrs, ctypes.c_void_p), len(addrs),
                  ctypes.cast(c_ints, ctypes.c_void_p), len(ints),
                  ctypes.cast(c_floats, ctypes.c_void_p), len(floats))
    seen = list(zip(seen_busy.unbind(0), seen_ratio.unbind(0)))
    return (out_eng, out_fab, out_nic, line_sent, page_sent, stalls, seen)
