"""Synthetic LLC-miss trace generation from WorkloadParams.

Deterministic (seeded numpy), same trace replayed across all schemes and
network configs — paired comparisons, like replaying the same binary in the
paper's Sniper runs. A trace is a struct of arrays:

  page (R,) int32 | off (R,) int32 in [0,64) | gap (R,) f32 ns | wr (R,) bool
"""
from __future__ import annotations

import zlib
from typing import NamedTuple

import numpy as np

from repro_torch.sim.workloads import WorkloadParams


class Trace(NamedTuple):
    page: np.ndarray
    off: np.ndarray
    gap: np.ndarray
    wr: np.ndarray
    n_pages: int


def generate_trace(w: WorkloadParams, n_requests: int, seed: int = 0
                   ) -> Trace:
    # crc32, NOT hash(): str hashes are salted per process, which silently
    # broke cross-process determinism (and the benchmark trace cache)
    rng = np.random.default_rng(seed * 9176
                                + zlib.crc32(w.name.encode()) % 65536)
    k = w.streams
    # active stream state: current page, lines remaining, next offset
    pages = np.zeros(k, np.int64)
    remaining = np.zeros(k, np.int64)
    offsets = np.zeros(k, np.int64)
    seq_counter = rng.integers(0, w.n_pages)

    # zipf page sampler via inverse-CDF over ranks (cheap approximation)
    ranks = np.arange(1, w.n_pages + 1, dtype=np.float64)
    probs = ranks ** (-w.zipf) if w.zipf > 0 else np.ones_like(ranks)
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    perm = rng.permutation(w.n_pages)  # rank -> page id (decorrelate ids)

    page_out = np.zeros(n_requests, np.int32)
    off_out = np.zeros(n_requests, np.int32)

    pick = rng.integers(0, k, size=n_requests)
    useq = rng.random(n_requests)
    uz = rng.random(n_requests)
    burst = np.maximum(1, rng.poisson(w.lines_per_visit, size=n_requests))

    for i in range(n_requests):
        s = pick[i]
        if remaining[s] <= 0:
            if useq[i] < w.seq_frac:
                seq_counter = (seq_counter + 1) % w.n_pages
                pages[s] = seq_counter
            else:
                pages[s] = perm[np.searchsorted(cdf, uz[i])]
            remaining[s] = min(64, burst[i])
            offsets[s] = rng.integers(0, 64)
        page_out[i] = pages[s]
        off_out[i] = offsets[s]
        offsets[s] = (offsets[s] + 1) % 64
        remaining[s] -= 1

    gap = rng.exponential(w.gap_ns, size=n_requests).astype(np.float32)
    wr = rng.random(n_requests) < w.dirty_frac
    return Trace(page_out, off_out, gap, wr, w.n_pages)


def merge_traces(traces, seed: int = 0) -> Trace:
    """Interleave per-core traces into one shared-resource trace (fig 18);
    pages are namespaced per core. Round-robin with jittered order."""
    rng = np.random.default_rng(seed)
    n = min(len(t.page) for t in traces)
    k = len(traces)
    order = rng.permuted(np.tile(np.arange(k), n)[: n * k])
    idx = np.zeros(k, np.int64)
    page, off, gap, wr = [], [], [], []
    base = 0
    bases = []
    for t in traces:
        bases.append(base)
        base += t.n_pages
    for c in order:
        i = idx[c]
        if i >= n:
            continue
        page.append(traces[c].page[i] + bases[c])
        off.append(traces[c].off[i])
        gap.append(traces[c].gap[i] / k)  # k cores issue concurrently
        wr.append(traces[c].wr[i])
        idx[c] += 1
    return Trace(np.asarray(page, np.int32), np.asarray(off, np.int32),
                 np.asarray(gap, np.float32), np.asarray(wr, bool), base)
