"""DaeMon paged-KV serving: generation + movement-ledger comparison.

Runs batched decode with the two-tier DaeMon KV store handling KV page
residency — B tenant sequences against M memory modules on ONE movement
fabric — twice: once DaeMon-style (critical sub-block fetches +
compressed page migrations + adaptive selection) and once Remote-style
(uncompressed page-only movement), and reports wire bytes and hit ratios
per tenant and per module; then the residency plane's capacity-squeezed
and roomy tenants (with the telemetry plane at level "trace" and a
Perfetto export written to ``--trace-out``), and replicated serving of
two replicas on one hot module.

  PYTHONPATH=src python -m repro_torch.examples.serve_paged \
      [--device cpu] [--trace-out TRACE_tenants.json] [--steps 120]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import telemetry
from repro_torch.core.compute_plane import tree_map
from repro_torch.core.daemon_store import (SERIES_CHANNELS, KVStoreConfig,
                                           init_kv_store_batch, ledger,
                                           link_bytes_per_step,
                                           step_fetch_batch)
from repro_torch.core.fabric import FabricConfig, scheduled_link
from repro_torch.device import resolve_device
from repro_torch.models.model import init_model
from repro_torch.runtime import obs
from repro_torch.runtime.fault import LinkHealthMonitor
from repro_torch.runtime.serve_loop import (PagedServeConfig, ServeConfig,
                                            serve_batch_paged,
                                            serve_replicated)
from repro_torch.sim.workloads import make_link_schedule

BATCH = 4
MODULES = 4


def kv_movement_ledger(compress: bool, device, steps: int = 120,
                       placement: str = "interleave"):
    """Replay zipf page-access streams for BATCH tenants through the
    two-tier store sharing one MODULES-wide fabric."""
    cfg = KVStoreConfig(num_local_pages=16, page_tokens=16, kv_heads=4,
                        head_dim=64, compress_pages=compress,
                        page_budget_per_step=8,
                        fabric=FabricConfig(num_modules=MODULES,
                                            placement=placement))
    state = init_kv_store_batch(cfg, BATCH, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    # the store's pools are bf16, and the card's kernels take the remote
    # pages in the pools' type
    remote_k = torch.randn((64, 16, 4, 64), generator=gen,
                           device=device).to(torch.bfloat16)
    remote_v = torch.randn((64, 16, 4, 64), generator=gen,
                           device=device).to(torch.bfloat16)
    rng = np.random.default_rng(0)
    pages = (rng.zipf(1.4, size=(steps, BATCH, 4)).clip(1, 64) - 1).astype(
        np.int32)
    offs = rng.integers(0, 16, size=(steps, BATCH, 4)).astype(np.int32)
    for t in range(steps):
        state, _, _, _ = step_fetch_batch(state, cfg, remote_k, remote_v,
                                          pages[t], offs[t])
    return ledger(state)


def tenant_capacity_demo(device, trace_out: str, steps: int = 120):
    """Residency-plane demo: one capacity-SQUEEZED tenant (hot set spans
    the whole remote region, far beyond its pool) and one ROOMY tenant
    (hot set fits the pool) share ONE movement fabric: the squeezed
    tenant churns (evictions, dirty writebacks, low hit ratio) while the
    roomy one converges to ~all hits, both contending for the same
    per-module channels."""
    cfg = KVStoreConfig(num_local_pages=8, page_tokens=16, kv_heads=4,
                        head_dim=64, page_budget_per_step=8, policy="lru",
                        fabric=FabricConfig(num_modules=2),
                        telemetry=telemetry.TelemetryConfig(
                            level="trace", lat_lo=0.01, lat_hi=1e4))
    state = init_kv_store_batch(cfg, 2, device=device)
    remote = torch.zeros((128, 16, 4, 64), dtype=torch.bfloat16,
                         device=device)
    rng = np.random.default_rng(0)
    squeezed = (rng.zipf(1.3, size=(steps, 4)).clip(1, 64) - 1)
    roomy = squeezed % 8 + 64
    pages = np.stack([squeezed, roomy], axis=1).astype(np.int32)
    offs = rng.integers(0, 16, size=(steps, 2, 4)).astype(np.int32)
    writes = np.ones((steps, 2, 4), bool)
    rec = obs.SpanRecorder()
    with rec.span("tenant_replay", steps=steps) as sp:
        for t in range(steps):
            state, *_ = step_fetch_batch(state, cfg, remote, remote,
                                         pages[t], offs[t], writes[t])
        sp["sync"] = state.fab.page_busy
    stats = state.seqs.stats
    print(f"\n== residency plane: capacity-squeezed vs roomy tenant "
          f"(pool=8 slots each, policy={cfg.policy}, shared fabric) ==")
    for b, name in ((0, "squeezed (64-page hot set)"),
                    (1, "roomy    (8-page hot set)")):
        hits = float(stats["local_hits"][b])
        reqs = float(stats["requests"][b])
        print(f"  tenant {b} {name}: "
              f"evictions={float(stats['evictions'][b]):.0f} "
              f"dirty_evicts={float(stats['dirty_evicts'][b]):.0f} "
              f"writeback={float(stats['writeback_bytes'][b]) / 1e3:.1f}KB "
              f"hit={hits / max(reqs, 1):.2f}")
    led = ledger(state)
    print(f"  shared fabric: wire={led['wire_bytes'] / 1e6:.2f}MB "
          f"per-module MB="
          f"{'/'.join(f'{b / 1e6:.2f}' for b in led['module_bytes'])}")
    print(f"  tail: stall p50={led['stall_p50_steps']:.3g} "
          f"p90={led['stall_p90_steps']:.3g} "
          f"p99={led['stall_p99_steps']:.3g} decode steps (both tenants)")
    print(obs.summary("squeezed-vs-roomy tenants", state.seqs.tel,
                      cfg.telemetry, SERIES_CHANNELS, unit="steps"))
    counters = []
    for b, pid in ((0, 1), (1, 2)):
        tel = tree_map(lambda x: x[b], state.seqs.tel)
        counters += obs.counter_events(tel, cfg.telemetry, SERIES_CHANNELS,
                                       pid=pid, t0_us=rec.events[0]["ts"])
    obs.trace_export(trace_out, spans=rec.events, counters=counters,
                     metadata={"tenant-replay": 0, "tenant-0 squeezed": 1,
                               "tenant-1 roomy": 2})
    print(f"  trace written: {trace_out} (ui.perfetto.dev)")
    return led


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when left out")
    ap.add_argument("--trace-out", default=None,
                    help="Perfetto trace of the tenant demo (default: "
                         "TRACE_tenants.json in a new temporary directory)")
    ap.add_argument("--steps", type=int, default=120,
                    help="store steps of the ledger and tenant replays")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    trace_out = args.trace_out or os.path.join(
        tempfile.mkdtemp(prefix="repro_serve_paged_"), "TRACE_tenants.json")

    print(f"== generation with paged-KV movement plane "
          f"(reduced qwen3-1.7b, B={BATCH}, M={MODULES}, on {device}) ==")
    cfg = get_config("qwen3-1.7b").reduced()
    params = init_model(cfg, torch.Generator(device=device).manual_seed(0))
    prompts = torch.randint(2, 200, (BATCH, 6), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1))
    store_cfg = KVStoreConfig(
        num_local_pages=8, page_tokens=4, kv_heads=2, head_dim=32,
        page_budget_per_step=4, adaptive_ratio=True,
        fabric=FabricConfig(num_modules=MODULES, placement="affinity",
                            affinity_block=8))
    # time-varying link: module 0's health flaps to near-dead mid-decode
    # (knot times are decode steps); the health monitor watches it and
    # surfaces a reshard advisory in the ledger
    n_steps = 6 + 10
    link = scheduled_link(
        link_bytes_per_step(store_cfg),
        make_link_schedule("flap", float(n_steps), MODULES, knots=8),
        MODULES, device=device)
    out, led = serve_batch_paged(params, cfg, prompts,
                                 ServeConfig(max_new_tokens=10), store_cfg,
                                 PagedServeConfig(window_pages=2,
                                                  pages_per_seq=8),
                                 link=link,
                                 health_monitor=LinkHealthMonitor(patience=2),
                                 device=device)
    for row in out:
        print("  gen:", row.tolist())
    hr = led["local_hits"] / max(led["requests"], 1)
    print(f"  decode movement: wire={led['wire_bytes'] / 1e3:.1f}KB "
          f"pages={led['page_moves']:.0f} "
          f"sub_blocks={led['sub_block_fetches']:.0f} hit={hr:.2f} "
          f"reshard_advised={led['link_reshard_modules']}")

    print(f"\n== DaeMon KV movement ledger vs Remote-style "
          f"(B={BATCH} tenants x M={MODULES} modules) ==")
    daemon = kv_movement_ledger(True, device, args.steps)
    remote = kv_movement_ledger(False, device, args.steps)
    for name, led_ in (("daemon", daemon), ("remote-style", remote)):
        hr = led_["local_hits"] / max(led_["requests"], 1)
        per_mod = "/".join(f"{b / 1e6:.2f}" for b in led_["module_bytes"])
        print(f"  {name:13s} wire={led_['wire_bytes'] / 1e6:7.2f}MB "
              f"(raw {led_['uncompressed_bytes'] / 1e6:7.2f}MB) "
              f"pages={led_['page_moves']:.0f} "
              f"sub_blocks={led_['sub_block_fetches']:.0f} hit={hr:.2f} "
              f"per-module MB={per_mod}")
    saving = 1 - daemon["wire_bytes"] / remote["wire_bytes"]
    print(f"  => DaeMon moves {saving * 100:.1f}% fewer wire bytes at equal "
          "service (compressed page plane + critical sub-blocks)")

    tenants = tenant_capacity_demo(device, trace_out, args.steps)

    print("\n== replicated serving: C=2 replicas contending on ONE hot "
          "module ==")
    params2 = init_model(cfg, torch.Generator(device=device).manual_seed(2))
    prompts2 = torch.randint(2, 200, (2, 4), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(3))
    rep_cfg = KVStoreConfig(
        num_local_pages=4, page_tokens=2, kv_heads=2, head_dim=32,
        page_budget_per_step=2, fabric=FabricConfig(num_modules=1))
    toks, rep = serve_replicated(params2, cfg, prompts2,
                                 ServeConfig(max_new_tokens=10), rep_cfg,
                                 num_replicas=2,
                                 pcfg=PagedServeConfig(window_pages=2,
                                                       pages_per_seq=8),
                                 device=device)
    hr = rep["local_hits"] / max(rep["requests"], 1)
    print(f"  tokens: {tuple(toks.shape)} (C, B, P+new)")
    print(f"  wire={rep['wire_bytes'] / 1e3:.1f}KB "
          f"writebacks={rep['writeback_bytes'] / 1e3:.1f}KB hit={hr:.2f}")
    print(f"  shared module KB: "
          f"{'/'.join(f'{b / 1e3:.1f}' for b in rep['module_bytes'])}  "
          f"per-replica NIC KB: "
          f"{'/'.join(f'{b / 1e3:.1f}' for b in rep['unit_bytes'])}")
    return {"daemon": daemon, "remote": remote, "saving": saving,
            "tenants": tenants, "replicated": rep, "trace": trace_out}


if __name__ == "__main__":
    main()
