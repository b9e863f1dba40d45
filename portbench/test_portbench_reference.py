"""The plain references against the port at reduced sizes on the CPU:
the decoder forward (dense and mixture-of-experts) against the port's
decode through its cache, and the NumPy store against the port's store
stepper; and the lower-precision controls against the program."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import cell, control, judge, smoke
from portbench.reference import dense, moe, store

REFERENCES = {"dense": dense, "moe": moe}


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_decoder_reference_matches_port_decode(family):
    from repro_torch.models.model import (ModelOptions, decode_step,
                                          init_decode_state)
    cfg = smoke.config(family)
    arch = cell.port_arch(cfg)
    w = cell.make_weights(cfg, 2 ** 31 + 7, "cpu")
    params = cell.port_params(w, family)
    tokens = torch.as_tensor(cell.prompts(5, 0, 3, 9, cfg["vocab_size"]))
    opt = ModelOptions(remat="none")
    state = init_decode_state(arch, 3, 9, opt, device="cpu")
    port = []
    for pos in range(9):
        logits, state = decode_step(params, arch, state,
                                    tokens[:, pos:pos + 1], pos, opt)
        port.append(logits[:, :cfg["vocab_size"]])
    port = torch.stack(port, dim=1)
    ref = REFERENCES[family].logits(w, cfg, tokens)
    assert ref.shape == port.shape
    np.testing.assert_allclose(ref.numpy(), port.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_tied_reference_matches_port_decode():
    from repro_torch.models.model import (ModelOptions, decode_step,
                                          init_decode_state)
    cfg = dict(smoke.config("dense"), tie_word_embeddings=True)
    arch = cell.port_arch(cfg)
    w = cell.make_weights(cfg, 2 ** 31 + 8, "cpu")
    assert w["unembed"] is w["embed"]
    params = cell.port_params(w, "dense")
    tokens = torch.as_tensor(cell.prompts(6, 0, 2, 7, cfg["vocab_size"]))
    opt = ModelOptions(remat="none")
    state = init_decode_state(arch, 2, 7, opt, device="cpu")
    port = []
    for pos in range(7):
        logits, state = decode_step(params, arch, state,
                                    tokens[:, pos:pos + 1], pos, opt)
        port.append(logits[:, :cfg["vocab_size"]])
    port = torch.stack(port, dim=1)
    untied = dict(w, unembed=torch.zeros_like(w["embed"]))
    ref = dense.logits(untied, cfg, tokens)
    np.testing.assert_allclose(ref.numpy(), port.numpy(), rtol=2e-4,
                               atol=2e-4)


def _port_ledger(g, batch, steps, window, pages_per_seq):
    from repro_torch.core import daemon_store as ds
    from repro_torch.core import residency
    from repro_torch.core.fabric import FabricConfig
    from repro_torch.core.params import DaemonParams
    from repro_torch.runtime.serve_loop import paged_request_window
    cfg = ds.KVStoreConfig(
        num_local_pages=g["num_local_pages"], page_tokens=g["page_tokens"],
        kv_heads=g["kv_heads"], head_dim=g["head_dim"],
        daemon=DaemonParams(bw_ratio=g["bw_ratio"]),
        compress_pages=g["compress_pages"],
        page_budget_per_step=g["page_budget_per_step"],
        fabric=FabricConfig(num_modules=g["num_modules"]),
        policy=g["policy"], pool_ways=g["pool_ways"])
    kv = ds.init_kv_store_batch(cfg, batch, device="cpu")
    shape = (batch * pages_per_seq, g["page_tokens"], g["kv_heads"],
             g["head_dim"])
    remote = torch.zeros(shape, dtype=torch.bfloat16)
    seq = torch.arange(batch, dtype=torch.int32)
    pol = residency.as_policy(g["policy"])
    for pos in range(steps):
        need, offs, writes = paged_request_window(
            torch.full((batch,), pos, dtype=torch.int32), seq,
            g["page_tokens"], window, pages_per_seq)
        kv, _, _, _ = ds.step_fetch_batch(kv, cfg, remote, remote, need,
                                          offs, writes, policy=pol)
    return ds.ledger(kv)


STORES = [
    (smoke.STORE, 3, 20, 3, 8),
    (dict(smoke.STORE, num_local_pages=8, pool_ways=8, policy="fifo",
          compress_pages=False, page_budget_per_step=1, bw_ratio=0.4,
          num_modules=1, kv_heads=1, head_dim=8), 4, 30, 4, 12),
    (dict(smoke.STORE, num_local_pages=6, pool_ways=3, page_tokens=1,
          page_budget_per_step=4, num_modules=3, kv_heads=1, head_dim=8),
     5, 40, 3, 20),
    # the paged cell's store (4 local pages as 2 sets x 2 ways, 16-token
    # pages, window 4) on narrow rows, past its fifth page
    (dict(smoke.STORE, num_local_pages=4, pool_ways=2, page_tokens=16,
          page_budget_per_step=4, num_modules=1, kv_heads=1, head_dim=8),
     2, 100, 4, 16),
]


@pytest.mark.parametrize("case", range(len(STORES)))
def test_store_reference_matches_port_ledger(case):
    g, batch, steps, window, pps = STORES[case]
    got = _port_ledger(g, batch, steps, window, pps)
    want, landings, misses = store.simulate(g, batch, 0, steps, window, pps)
    assert judge.ledger_mismatch(got, want) == []
    assert got["stall_steps"] == want["stall_steps"]
    assert len(landings) == len(misses) == steps
    assert sum(misses) == want["requests"] - want["local_hits"]


def test_store_reference_moves_pages_and_writes_back():
    g, batch, steps, window, pps = STORES[0]
    want = store.simulate(g, batch, 0, steps, window, pps)[0]
    assert want["evictions"] > 0 and want["dirty_evicts"] > 0
    assert want["wire_bytes"] == sum(want["module_bytes"])


def test_store_control_fails_the_stall_comparison():
    g, batch, steps, window, pps = STORES[0]
    want = store.simulate(g, batch, 0, steps, window, pps)[0]
    low = store.simulate(g, batch, 0, steps, window, pps,
                         rounding="bfloat16")[0]
    assert judge.stall_rel_gap(low, want) > 1e-3


def _mid_size_spec():
    """A dense cell at qwen3-1.7b's head width and twice the smoke's
    depth in bfloat16, 4 sequences of 8 + 48 tokens: enough served
    tokens for the control's gaps to show."""
    spec = smoke.spec("serve_batch", "dense", "bfloat16")
    sizes = {"hidden_size": 1024, "intermediate_size": 3072,
             "num_hidden_layers": 8, "num_attention_heads": 8,
             "num_key_value_heads": 4, "head_dim": 128, "vocab_size": 8192}
    spec["config"].update(sizes)
    spec["config"]["port_overrides"].update(
        d_model=1024, d_ff=3072, num_layers=8, num_heads=8, num_kv_heads=4,
        head_dim=128, vocab_size=8192)
    spec["traffic"].update(batch=4, calls=[[8, 48]], sample_sequences=4)
    return spec


def test_fp8_control_reads_far_above_the_program():
    spec = _mid_size_spec()
    for seed in (1, 2, 2 ** 31 + 3):
        row = control.readings(spec, seed, "cpu")
        prog, ctrl = row["program"], row["control"]
        assert row["served"] == 4 * 48
        assert ctrl["logit_gap"] > 3 * prog["logit_gap"]
        assert ctrl["logit_gap_mean"] > 3 * prog["logit_gap_mean"]
        assert row["control_tokens_off"] > row["tokens_off"]


def test_control_fails_the_cells_own_limits():
    spec = smoke.spec("serve_batch_paged", "dense", "bfloat16")
    spec["limits"] = cell.load("qwen3-1.7b.paged-b16")["limits"]
    row = control.readings(spec, 2 ** 31 + 17, "cpu")
    assert row["program_correct"] is True
    assert row["control_correct"] is False
    checks = row["control_checks"]
    assert set(checks) == set(spec["limits"])
    assert any(c["value"] > c["limit"] for c in checks.values())
