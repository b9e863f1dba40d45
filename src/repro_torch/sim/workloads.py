"""The paper's 13 workloads as parameterized memory-access models (Table 3)
plus the time-varying link-schedule profiles the robustness axis replays.

Each workload is reduced to the features that drive data-movement behavior
in a fully disaggregated system:
  * spatial locality  — distinct cache lines touched per page visit;
  * concurrency       — interleaved page streams (what makes critical lines
                        collide with other pages' bulk moves);
  * reuse             — zipf exponent over the page footprint;
  * memory intensity  — mean compute gap between LLC misses;
  * compressibility   — LZ wire ratio (paper fig 12: avg 4.47x, dr/rs 1.42x).

Values are calibrated against the paper's own aggregates (§6, fig 3/8/9/10)
— see tests/test_sim.py, tests/test_movement_plane.py and
EXPERIMENTS.md §Benchmarks.

Link profiles (`LINK_PROFILES` / `make_link_schedule`) are the scenario
axis of the paper's robustness claim ("high runtime variability in network
latencies/bandwidth", fig 13): piecewise-constant bandwidth-multiplier +
per-module health schedules that `desim.make_net` attaches to the fabric's
`LinkModel` and `benchmarks/robustness.py` sweeps against the scheme
lattice. Every profile emits the same knot count so different profiles
stack on the lattice's net axis — one compiled program, no per-profile
recompiles.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class WorkloadParams:
    name: str
    domain: str
    locality: str            # poor | medium | high (paper's three classes)
    lines_per_visit: float   # mean distinct lines touched per page visit
    streams: int             # concurrent page streams
    gap_ns: float            # mean compute time between LLC misses
    n_pages: int             # working-set footprint in 4KB pages
    zipf: float              # page-reuse skew (0 = uniform/streaming)
    seq_frac: float          # fraction of sequential page selection
    dirty_frac: float        # fraction of writing accesses
    comp_ratio: float        # LZ link-compression ratio (fig 12)
    fpcbdi_ratio: float = 1.55  # latency-optimized schemes: ~2.92x lower
    fve_ratio: float = 1.65     # ~2.73x lower than LZ on average


# Footprints are sim-scaled (16-32MB; the paper's 43MB-1.3GB working sets
# would need 10x-longer traces for steady state) — the local:remote 20%
# capacity ratio, which drives all relative behavior, is preserved.
WORKLOADS = {
    # --- poor locality within pages (kc, tr, pr, nw) ---
    "kc": WorkloadParams("kc", "graph", "poor", 10.0, 12, 4.0, 4096,
                         1.30, 0.05, 0.10, 4.10),
    "tr": WorkloadParams("tr", "graph", "poor", 12.0, 10, 5.5, 4096,
                         1.25, 0.05, 0.05, 3.60),
    "pr": WorkloadParams("pr", "graph", "poor", 8.0, 16, 3.0, 6144,
                         1.35, 0.05, 0.15, 4.60),
    "nw": WorkloadParams("nw", "bio", "poor", 9.0, 12, 3.5, 4096,
                         1.15, 0.30, 0.25, 5.20),
    # --- medium locality (bf, bc, ts) — page channel near saturation ---
    "bf": WorkloadParams("bf", "graph", "medium", 22.0, 8, 11.0, 4096,
                         1.15, 0.15, 0.10, 4.30),
    "bc": WorkloadParams("bc", "graph", "medium", 26.0, 8, 10.0, 4096,
                         1.15, 0.15, 0.10, 4.10),
    "ts": WorkloadParams("ts", "analytics", "medium", 30.0, 6, 14.0, 3072,
                         1.05, 0.40, 0.05, 5.60),
    # --- high locality (sp, sl, hp, pf, dr, rs) — latency/queueing mixed,
    #     page channel only mildly saturated (paper: PQ ~= Remote here) ---
    "sp": WorkloadParams("sp", "linalg", "high", 48.0, 4, 26.0, 3072,
                         1.00, 0.60, 0.05, 5.60),
    "sl": WorkloadParams("sl", "ml", "high", 54.0, 4, 30.0, 6144,
                         1.00, 0.55, 0.05, 6.10),
    "hp": WorkloadParams("hp", "hpc", "high", 50.0, 4, 26.0, 3072,
                         0.95, 0.70, 0.15, 5.10),
    "pf": WorkloadParams("pf", "hpc", "high", 56.0, 4, 32.0, 3072,
                         0.95, 0.70, 0.20, 5.60),
    "dr": WorkloadParams("dr", "ml", "high", 56.0, 4, 28.0, 4096,
                         0.90, 0.75, 0.05, 1.42),
    "rs": WorkloadParams("rs", "ml", "high", 58.0, 4, 28.0, 4096,
                         0.90, 0.75, 0.05, 1.42),
}

POOR = ("kc", "tr", "pr", "nw")
MEDIUM = ("bf", "bc", "ts")
HIGH = ("sp", "sl", "hp", "pf", "dr", "rs")
ORDER = POOR + MEDIUM + HIGH


# --------------------------------------------------- link-schedule profiles
@dataclass(frozen=True)
class LinkProfile:
    """A time-varying link scenario, reduced to the knobs that matter:

    kind       — constant | burst | degrade | flap
    depth      — bandwidth multiplier inside a contention burst
    floor      — terminal multiplier of a progressive degradation ramp
    bursts     — contention episodes across the horizon (burst/flap)
    duty       — fraction of each episode period spent degraded
    fail_module/fail_health — which module's link flaps, and how low its
                 health mask drops while flapping (flap only)
    """
    name: str
    kind: str
    depth: float = 0.35
    floor: float = 0.40
    bursts: int = 4
    duty: float = 0.5
    fail_module: int = 0
    fail_health: float = 0.1


LINK_PROFILES = {
    "constant": LinkProfile("constant", "constant"),
    # heavy background contention bursts: 15% of bandwidth left
    "burst": LinkProfile("burst", "burst", depth=0.15),
    # progressive congestion: ramps to a quarter of nominal bandwidth
    "degrade": LinkProfile("degrade", "degrade", floor=0.25),
    # one module's link flapping to near-dead
    "flap": LinkProfile("flap", "flap", fail_health=0.05),
}


def make_link_schedule(profile, horizon: float, num_modules: int = 1,
                       knots: int = 24):
    """Piecewise-constant link schedule over [0, horizon).

    Returns (sched_t (K,), mult (K, M), health (K, M)) numpy arrays for
    `desim.make_net(schedule=...)` / `fabric.LinkModel`. The last segment
    persists past the horizon (searchsorted-clip semantics), so an
    underestimated horizon degrades gracefully. All profiles emit the
    same K for a given `knots`, so a profile sweep rides ONE compiled
    lattice as data on the net axis.
    """
    p = LINK_PROFILES[profile] if isinstance(profile, str) else profile
    k, m = int(knots), int(num_modules)
    if k < 2:
        raise ValueError("knots must be >= 2")
    t = np.linspace(0.0, float(horizon), k, endpoint=False,
                    dtype=np.float32)
    mult = np.ones((k, m), np.float32)
    health = np.ones((k, m), np.float32)
    if p.kind == "burst":
        period = max(2, k // p.bursts)
        in_burst = (np.arange(k) % period) < max(1, round(period * p.duty))
        mult[in_burst, :] = p.depth
    elif p.kind == "degrade":
        mult[:] = np.linspace(1.0, p.floor, k,
                              dtype=np.float32)[:, None]
    elif p.kind == "flap":
        period = max(2, k // p.bursts)
        down = (np.arange(k) % period) < max(1, round(period * p.duty))
        health[down, p.fail_module % m] = p.fail_health
    elif p.kind != "constant":
        raise ValueError(f"unknown link profile kind {p.kind!r}")
    return t, mult, health
