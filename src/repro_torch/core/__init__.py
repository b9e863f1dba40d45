"""Movement substrate and the two-tier KV store.

PyTorch counterpart of ``repro.core``, with the same exports:

bandwidth.py     §4.1 approximate bandwidth partitioning (virtual
                 channels), the adaptive repartitioning control law and
                 the scalar `Channel` / `PartitionedLink` API
fabric.py        multi-module movement fabric: per-module channel banks,
                 time-varying LinkModel, page->module placement,
                 per-module wire-byte ledgers, the merge across ranks
compute_plane.py per-unit state helpers, request->unit sharding, per-unit
                 NIC channel banks and two-leg service pricing
compression.py   §4.4 link compression (int8/int4 blocks, error feedback)
engine.py        DaeMon compute/memory engines (inflight buffers, §4.2
                 selection unit, §4.3 dirty unit)
residency.py     the set-associative local-memory tier and the
                 replacement-policy registry
daemon_store.py  two-tier paged KV store for serving
params.py        hardware constants from paper Table 1/2
"""
from repro_torch.core.bandwidth import (RATIO_MAX, RATIO_MIN, Channel,
                                        PartitionedLink, adapt_ratio,
                                        init_channel, init_link,
                                        occupy_busy, send_line, send_page,
                                        serve_dual, shares, transmit)
from repro_torch.core.fabric import (PLACEMENTS, FabricConfig, FabricState,
                                     LinkModel, adapt_ratio_at, backlog,
                                     constant_link, init_fabric, link_bw_at,
                                     module_health, place, sample_link,
                                     scheduled_link, serve_dual_at,
                                     serve_writeback_at, total_bytes)
from repro_torch.core.compute_plane import (ComputePlaneConfig,
                                            init_nic_bank, nic_link_for,
                                            replicate, serve_dual_two_leg,
                                            serve_writeback_two_leg,
                                            shard_unit, unit_bytes,
                                            unit_slice, unit_update)
from repro_torch.core.compression import (dequantize_block_int4,
                                          dequantize_block_int8,
                                          ef_compress, quantize_block_int4,
                                          quantize_block_int8)
from repro_torch.core.engine import (INVALID, MOVED, SCHEDULED, THROTTLED,
                                     EngineState, find, first_free,
                                     gate_tree, init_engine_state,
                                     note_dirty_eviction, poll_arrivals,
                                     retire_arrivals, schedule_line,
                                     schedule_page, select_granularity,
                                     utilization)
from repro_torch.core.params import DaemonParams, NetworkParams
from repro_torch.core.residency import (POLICIES, PolicyFlags, PolicySpec,
                                        ResidencyState, as_policy,
                                        evict_order, evict_victim,
                                        init_residency, insert, lookup,
                                        lookup_one, mark_dirty,
                                        stack_policies, touch)
