"""The evaluated data-movement schemes (paper §2.2 fig 3 + §6).

PyTorch counterpart of ``repro.sim.schemes``:

  Local      — monolithic: every access served from local memory
  cache-line — lines only, straight to LLC, no local-memory use
  Remote     — page-granularity only (the widely-adopted baseline)
  page-free  — line-latency serve + page materializes at zero cost (upper
               bound from fig 3)
  cl+page    — naive both granularities on ONE shared FIFO link
  LC         — Remote + ratio-optimized link compression (§4.4)
  BP         — decoupled dual-granularity + 25% bandwidth partitioning,
               ALWAYS both (no selection) (§4.1)
  PQ         — BP + selection granularity unit (§4.2), no compression
  DaeMon     — PQ + LC (the full design)
  DaeMon-adaptive — DaeMon with the §4.1 partition ratio as carried
               state, nudged by a per-module controller
               (`bandwidth.adapt_ratio`); `bw_ratio` is its seed value.

`SchemeFlags` is the human-facing registry entry (static Python bools).
`TraceableFlags` is its tensor twin: 0-d bool and f32 tensors, stacked
along a leading axis by `stack_flags` so the scheme axis is one more
batch axis of the simulator's lattice (`repro_torch.sim.desim.
simulate_lattice`). Every scheme switch in the simulator is a
`torch.where` on these tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Sequence

import torch


@dataclass(frozen=True)
class SchemeFlags:
    name: str
    local_only: bool = False     # Local
    move_lines: bool = True
    move_pages: bool = True
    page_free: bool = False
    partition: bool = False      # dual virtual channels (else shared FIFO)
    selection: bool = False      # §4.2 selection granularity unit
    compress: bool = False       # §4.4 link compression on pages
    use_local_mem: bool = True   # cache-line scheme: False
    adaptive: bool = False       # §4.1 ratio as adapted per-module state
    bw_ratio: float = 0.25       # static ratio / adaptive seed


class TraceableFlags(NamedTuple):
    """SchemeFlags as tensors (`name` dropped): bool leaves and an f32
    `bw_ratio`, 0-d for one scheme or (S,) when stacked."""
    local_only: torch.Tensor
    move_lines: torch.Tensor
    move_pages: torch.Tensor
    page_free: torch.Tensor
    partition: torch.Tensor
    selection: torch.Tensor
    compress: torch.Tensor
    use_local_mem: torch.Tensor
    adaptive: torch.Tensor
    bw_ratio: torch.Tensor


def as_traceable(flags, device=None) -> TraceableFlags:
    """SchemeFlags -> TraceableFlags on `device` (idempotent on
    TraceableFlags, which are moved only when `device` is given)."""
    if isinstance(flags, TraceableFlags):
        if device is None:
            return flags
        return TraceableFlags(*(t.to(device) for t in flags))
    return TraceableFlags(
        *(torch.tensor(bool(getattr(flags, f)), dtype=torch.bool,
                       device=device)
          for f in TraceableFlags._fields[:-1]),
        bw_ratio=torch.tensor(flags.bw_ratio, dtype=torch.float32,
                              device=device))


def stack_flags(flags_list: Sequence, device=None) -> TraceableFlags:
    """Stack schemes along a leading axis (the lattice's scheme axis)."""
    flags = [as_traceable(f, device) for f in flags_list]
    return TraceableFlags(*(torch.stack(leaves) for leaves in zip(*flags)))


SCHEMES = {
    "local": SchemeFlags("local", local_only=True),
    "cache-line": SchemeFlags("cache-line", move_pages=False,
                              use_local_mem=False),
    "remote": SchemeFlags("remote", move_lines=False),
    "page-free": SchemeFlags("page-free", page_free=True),
    "cl+page": SchemeFlags("cl+page", partition=False),
    "lc": SchemeFlags("lc", move_lines=False, compress=True),
    "bp": SchemeFlags("bp", partition=True),
    "pq": SchemeFlags("pq", partition=True, selection=True),
    "daemon": SchemeFlags("daemon", partition=True, selection=True,
                          compress=True),
    "daemon-adaptive": SchemeFlags("daemon-adaptive", partition=True,
                                   selection=True, compress=True,
                                   adaptive=True),
}

PAPER_FIG3 = ("local", "cache-line", "remote", "page-free", "cl+page",
              "daemon")
PAPER_FIG8 = ("remote", "lc", "bp", "pq", "daemon", "local")


def with_ratio(flags: SchemeFlags, ratio: float) -> SchemeFlags:
    return replace(flags, bw_ratio=ratio)
