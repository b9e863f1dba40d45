"""The plain references against the port at reduced sizes on the CPU:
the decoder forward (dense and mixture-of-experts) against the port's
decode through its cache, and the NumPy store against the port's store
stepper; the weights each configuration's reference has drawn; and the
lower-precision controls against the program."""
from __future__ import annotations

import hashlib
import sys
import types

import numpy as np
import pytest
import torch

from portbench import cell, control, harness, judge, smoke
from portbench.reference import dense, moe, store

REFERENCES = {"dense": dense, "moe": moe}


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_decoder_reference_matches_port_decode(family):
    from repro_torch.models.model import (ModelOptions, decode_step,
                                          init_decode_state)
    cfg = smoke.config(family)
    arch = cell.port_arch(cfg)
    w = cell.make_weights(cfg, 2 ** 31 + 7, "cpu")
    params = cell.port_params(w, cfg)
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
    params = cell.port_params(w, cfg)
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


# per leaf: shape, dtype and the first 16 hex digits of the sha256 of its
# bytes at seed 2**31 + 11, as the weights were drawn before each
# configuration's reference listed its own leaves
PINNED = {
    "dense-tied-bf16": [
        ("embed", (512, 64), "bfloat16", "977d8d6708b336e6"),
        ("norm1", (4, 64), "float32", "62d69d32521dd944"),
        ("wq", (4, 64, 4, 16), "bfloat16", "7db61b48c74ca24e"),
        ("wk", (4, 64, 2, 16), "bfloat16", "c48fd170c9fb0220"),
        ("wv", (4, 64, 2, 16), "bfloat16", "bfd409b7786b994d"),
        ("wo", (4, 4, 16, 64), "bfloat16", "7d1598726ad29a51"),
        ("q_norm", (4, 16), "float32", "3705f88707fefed8"),
        ("k_norm", (4, 16), "float32", "ba5417b982a3a784"),
        ("norm2", (4, 64), "float32", "30da52706b3d4d5b"),
        ("w_gate", (4, 64, 128), "bfloat16", "638950672dd7e2cd"),
        ("w_up", (4, 64, 128), "bfloat16", "82d594f275f3b366"),
        ("w_down", (4, 128, 64), "bfloat16", "56cdf22e74f9b520"),
        ("final_norm", (64,), "float32", "f5fdb0462e788805"),
        ("unembed", (512, 64), "bfloat16", "977d8d6708b336e6")],
    "moe": [
        ("embed", (512, 64), "float32", "426bba382af572ea"),
        ("norm1", (4, 64), "float32", "62d69d32521dd944"),
        ("wq", (4, 64, 4, 16), "float32", "c3d8e3de1bccb0bf"),
        ("wk", (4, 64, 2, 16), "float32", "2ea991661f38a82a"),
        ("wv", (4, 64, 2, 16), "float32", "eeada04fb4b6400c"),
        ("wo", (4, 4, 16, 64), "float32", "89d50b9e09a9da5e"),
        ("q_norm", (4, 16), "float32", "3705f88707fefed8"),
        ("k_norm", (4, 16), "float32", "ba5417b982a3a784"),
        ("norm2", (4, 64), "float32", "30da52706b3d4d5b"),
        ("router", (4, 64, 8), "float32", "01a8326c3662eed2"),
        ("w_gate", (4, 8, 64, 32), "float32", "4865c5fa79c8f6b9"),
        ("w_up", (4, 8, 64, 32), "float32", "b7cea00fdb32c81a"),
        ("w_down", (4, 8, 32, 64), "float32", "1094a834e37164cd"),
        ("final_norm", (64,), "float32", "529d98696b6cc48e"),
        ("unembed", (512, 64), "float32", "d1dec688101c50d8")],
}
PINNED_CONFIGS = {
    "dense-tied-bf16": lambda: dict(smoke.config("dense", "bfloat16"),
                                    tie_word_embeddings=True),
    "moe": lambda: smoke.config("moe"),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_weights_are_the_pinned_draw(name):
    w = cell.make_weights(PINNED_CONFIGS[name](), 2 ** 31 + 11, "cpu")
    got = [(k, tuple(t.shape), str(t.dtype).split(".")[1],
            hashlib.sha256(t.contiguous().view(torch.uint8).numpy()
                           .tobytes()).hexdigest()[:16])
           for k, t in w.items()]
    assert got == PINNED[name]


def test_configuration_names_its_own_reference(monkeypatch):
    """A configuration's `reference` module, not its family, gives the
    leaves drawn, their place in the port's tree and the logits."""
    seen = {}
    standin = types.ModuleType("portbench.reference.standin")

    def leaves(cfg, vocab_rows):
        seen["rows"] = vocab_rows
        return [("embed", (vocab_rows, 8), 1.0, torch.float32),
                ("extra", (3, 5), 0.5, torch.bfloat16),
                ("unembed", (vocab_rows, 8), 0.25, torch.float32)]

    def logits(w, cfg, tokens, quant=None):
        seen["logits"] = sorted(w)
        return torch.zeros(*tokens.shape, cfg["vocab_size"])

    standin.leaves = leaves
    standin.port_params = lambda w: {"tree": w["extra"]}
    standin.logits = logits
    monkeypatch.setitem(sys.modules, "portbench.reference.standin", standin)
    cfg = dict(smoke.config("dense"), reference="standin")
    w = cell.make_weights(cfg, 5, "cpu")
    assert list(w) == ["embed", "extra", "unembed"]
    assert seen["rows"] == cell.padded_vocab(cfg["vocab_size"]) == 512
    assert w["extra"].dtype == torch.bfloat16 and w["extra"].shape == (3, 5)
    gen = torch.Generator().manual_seed(5)
    torch.randn((512, 8), generator=gen)
    assert torch.equal(w["extra"], torch.randn(
        (3, 5), generator=gen, dtype=torch.bfloat16).mul_(0.5))
    assert cell.port_params(w, cfg)["tree"] is w["extra"]
    assert cell.reference(cfg) is standin
    assert cell.reference(smoke.config("dense")) is dense
    spec = {"config": cfg, "traffic": {"sample_sequences": 2},
            "limits": {"logit_gap": 1e-3}}
    served = torch.zeros((2, 7), dtype=torch.long)
    values, failed = harness.compare(spec, w, [(served, None, 3)], 5, None)
    assert seen["logits"] == ["embed", "extra", "unembed"]
    assert values["logit_gap"] == 0.0 and failed == 0
    tied = cell.make_weights(dict(cfg, tie_word_embeddings=True), 5, "cpu")
    assert list(tied) == ["embed", "extra", "unembed"]
    assert tied["unembed"] is tied["embed"]
    assert torch.equal(tied["embed"], torch.randn(
        (512, 8), generator=torch.Generator().manual_seed(5)).mul_(0.25))


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
