"""DaeMon hardware parameters (paper Table 1 / §5) + network model constants.

These sizes come straight from the paper: queue/buffer capacities are tied
to LLC MSHR counts, the bandwidth-partitioning ratio defaults to 25%, and
the MXT-style LZ compressor costs 64 cycles per 1KB (4 engines x 256B).
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class DaemonParams:
    # granularities
    line_bytes: int = 64
    page_bytes: int = 4096
    # engine structures (compute engine; memory engine scales 4x)
    sub_block_queue: int = 128
    page_queue: int = 256
    inflight_sb_buf: int = 128
    inflight_page_buf: int = 256
    dirty_data_buf: int = 256
    dirty_flush_threshold: int = 8      # §4.3: flush + throttle past this
    memory_engine_scale: int = 4        # memory engine serves 4 CCs
    # bandwidth partitioning (§4.1)
    bw_ratio: float = 0.25              # fraction reserved for cache lines
    # compression (§4.4): IBM-MXT style LZ, 4 engines x 256B, 64 cycles
    compress_cycles: int = 64
    cpu_ghz: float = 3.6

    @property
    def lines_per_page(self) -> int:
        """Page geometry: cache lines per page (the sub-block key packing
        stride used by `engine.pack_line` / `engine.retire_arrivals`).
        One knob — 4096/64 = 64 by default — instead of a hardcoded 64
        scattered across the movement plane."""
        return self.page_bytes // self.line_bytes

    @property
    def lines_per_page_slot(self) -> int:
        """Queue-controller interleave: CL slots served per page slot.

        4096/64 * r/(1-r); 25% -> ~21 lines per page (paper §4.1).
        """
        r = self.bw_ratio
        return max(1, round(self.page_bytes / self.line_bytes * r / (1 - r)))

    @property
    def compress_latency_ns(self) -> float:
        return self.compress_cycles / self.cpu_ghz

    def with_ratio(self, r: float) -> "DaemonParams":
        return replace(self, bw_ratio=r)


@dataclass(frozen=True)
class NetworkParams:
    """Paper §5: DDR4-ish 17 GB/s buses; network is bw_factor x slower."""
    dram_bw_gbps: float = 17.0
    bw_factor: float = 4.0              # network = dram_bw / bw_factor
    switch_latency_ns: float = 100.0    # propagation + switching delay
    local_mem_latency_ns: float = 50.0  # row access incl. controller
    remote_mem_latency_ns: float = 50.0
    translation_latency_ns: float = 50.0  # HW translation = 1 DRAM access

    @property
    def net_bw_bytes_per_ns(self) -> float:
        return self.dram_bw_gbps * (1.0 / self.bw_factor)

    @property
    def mem_bw_bytes_per_ns(self) -> float:
        return self.dram_bw_gbps
