"""Tiny cells for the benchmark's own tests on the CPU: the port's reduced
configurations (`qwen3-1.7b-reduced`, `olmoe-1b-7b-reduced`) with the
configuration file's keys, a store small enough to evict and write
back, and a traffic mix of two calls of short prompts; limits fit for
float32 on both sides."""
from __future__ import annotations

import json

from portbench.cell import ROOT

STORE = {"num_local_pages": 4, "pool_ways": 2, "page_tokens": 2,
         "kv_heads": 2, "head_dim": 16, "policy": "lru",
         "compress_pages": True, "page_budget_per_step": 2,
         "bw_ratio": 0.25, "num_modules": 2, "telemetry": "off"}


def config(family: str = "dense", dtype: str = "float32") -> dict:
    moe = family == "moe"
    cfg = {"name": f"tiny-{family}", "family": family,
           "port_config": ("olmoe-1b-7b" if moe else "qwen3-1.7b")
           + "-reduced",
           "vocab_size": 256, "hidden_size": 64,
           "intermediate_size": 32 if moe else 128, "num_hidden_layers": 4,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 16, "rope_theta": 1e4 if moe else 1e6,
           "rms_norm_eps": 1e-6, "torch_dtype": dtype, "store": STORE}
    if moe:
        cfg.update(num_experts=8, num_experts_per_tok=2, norm_topk_prob=True)
    if dtype != "float32":
        cfg["port_overrides"] = {"dtype": dtype}
    return cfg


def spec(entry: str = "serve_batch_paged", family: str = "dense",
         dtype: str = "float32") -> dict:
    tr = {"name": "tiny", "entry": entry, "batch": 3,
          "calls": [[5, 7], [3, 4]], "sample_sequences": 4,
          "trace_steps": [2, 6]}
    limits = {"logit_gap": 1e-3}
    if entry == "serve_batch_paged":
        tr["paged"] = {"window_pages": 3, "pages_per_seq": 8}
        limits.update(ledger_mismatch=0, stall_rel_gap=1e-6)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {"cell": {"name": "tiny", "config": "tiny", "traffic": "tiny",
                     "chips": 1},
            "config": config(family, dtype), "traffic": tr,
            "limits": limits,
            "end_to_end": bench["end_to_end"],
            "per_layer": bench["per_layer"]}
