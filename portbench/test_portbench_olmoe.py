"""The OLMoE configuration on the CPU: the port with the configuration's
`port_overrides` against the plain reference (`reference/olmoe.py`),
decoding through its cache and on the paged serve path; the
configuration file against the published sizes; the leaves the seed
draws; the expert layers' readers (`metrics/moe_*.py`) on synthetic
spans; and the lower-precision control against the program."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import cell, control, harness, moecounts, smoke
from portbench.reference import olmoe

CELL = "olmoe-1b-7b.paged-b16"
OVERRIDES = {"norm_topk_prob": False, "qk_norm_width": "full",
             "norm_eps": 1e-05}
READERS = ("moe_device_ms_per_step", "moe_launches_per_step", "moe_roofline")


def tiny(dtype: str = "float32") -> dict:
    """The smoke's MoE configuration (4 layers, 8 experts top-2, 4 x 16
    query heads over 2 KV heads) as OLMoE's block: its reference, the
    routing over all experts, eps 1e-5 and the three overrides."""
    cfg = dict(smoke.config("moe", dtype), name="tiny-olmoe",
               reference="olmoe", norm_topk_prob=False, rms_norm_eps=1e-05)
    cfg["port_overrides"] = {**cfg.get("port_overrides", {}), **OVERRIDES}
    return cfg


def test_port_decode_matches_the_reference():
    """As `test_decoder_reference_matches_port_decode`, at its tolerance:
    the port's decode through its cache, f32 on both sides."""
    from repro_torch.models.model import (ModelOptions, decode_step,
                                          init_decode_state)
    cfg = tiny()
    arch = cell.port_arch(cfg)
    assert (arch.norm_topk_prob, arch.qk_norm_width, arch.norm_eps) == \
        (False, "full", 1e-05)
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
    ref = olmoe.logits(w, cfg, tokens)
    assert ref.shape == port.shape
    np.testing.assert_allclose(ref.numpy(), port.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_paged_serve_matches_the_reference():
    """A whole run of the harness on the paged entry: the served tokens
    against the reference and the store's ledger against its NumPy
    reference, with the smoke's float32 limits."""
    spec = smoke.spec("serve_batch_paged", "moe")
    spec["config"] = tiny()
    result = harness.run_cell(spec, 2 ** 31 + 5, 0.2, False, "cpu",
                              time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0
    checks = result["checks"]
    assert checks["logit_gap"]["value"] <= 1e-3
    assert checks["ledger_mismatch"]["value"] == 0


def test_configuration_has_the_published_sizes():
    spec = cell.load(CELL)
    cfg = spec["config"]
    published = {"vocab_size": 50304, "hidden_size": 2048,
                 "intermediate_size": 1024, "num_hidden_layers": 16,
                 "num_attention_heads": 16, "num_key_value_heads": 16,
                 "num_experts": 64, "num_experts_per_tok": 8,
                 "norm_topk_prob": False, "rms_norm_eps": 1e-05,
                 "rope_theta": 10000.0, "tie_word_embeddings": False,
                 "torch_dtype": "bfloat16"}
    assert {k: cfg[k] for k in published} == published
    assert cfg["head_dim"] == cfg["hidden_size"] // cfg["num_attention_heads"]
    assert cfg["assumed"] == ["head_dim"] and cfg["reduced"] == []
    assert (cfg["family"], cfg["port_config"], cfg["reference"]) == \
        ("moe", "olmoe-1b-7b", "olmoe")
    assert cfg["port_overrides"] == OVERRIDES
    arch = cell.port_arch(cfg)
    assert (arch.norm_topk_prob, arch.qk_norm_width, arch.norm_eps) == \
        (False, "full", 1e-05)
    assert arch.param_count() == 6_919_161_856
    store = cell.store_geometry(spec)
    assert (store["kv_heads"], store["head_dim"]) == (16, 128)
    qwen3 = cell.load("qwen3-1.7b.paged-b16")
    assert {**store, "kv_heads": 8} == cell.store_geometry(qwen3)
    assert spec["traffic"] == qwen3["traffic"]


def test_leaves_have_the_full_width_norms():
    cfg = cell.load(CELL)["config"]
    rows = cell.padded_vocab(cfg["vocab_size"])
    shapes = {name: (shape, dtype)
              for name, shape, _, dtype in olmoe.leaves(cfg, rows)}
    bf16, f32 = torch.bfloat16, torch.float32
    assert shapes["q_norm"] == ((16, 2048), f32)
    assert shapes["k_norm"] == ((16, 2048), f32)
    assert shapes["router"] == ((16, 2048, 64), bf16)
    assert shapes["w_gate"] == shapes["w_up"] == ((16, 64, 2048, 1024), bf16)
    assert shapes["w_down"] == ((16, 64, 1024, 2048), bf16)
    assert shapes["embed"] == shapes["unembed"] == ((50688, 2048), bf16)
    assert list(shapes)[-1] == "unembed"


def test_a_seed_draws_the_same_weights():
    cfg = tiny("bfloat16")
    a, b = (cell.make_weights(cfg, 2 ** 31 + 11, "cpu") for _ in range(2))
    c = cell.make_weights(cfg, 2 ** 31 + 12, "cpu")
    assert list(a) == list(b) == [leaf[0] for leaf in olmoe.leaves(
        cfg, cell.padded_vocab(cfg["vocab_size"]))]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["q_norm"], c["q_norm"])
    assert a["q_norm"].shape == (4, 64) and a["k_norm"].shape == (4, 32)
    assert a["unembed"] is not a["embed"]
    tree = cell.port_params(a, cfg)["runs"][0]
    assert tree["attn"]["q_norm"] is a["q_norm"]
    assert tree["ffn"]["router"] is a["router"]


def _moe_events(steps: int, layers: int, tokens: int, routed):
    """A recorder's spans: `steps` steps, each a model decode holding
    `layers` expert layers whose k-th has `routed(step, k)` experts."""
    ev, sid = [], 0

    def add(name, ts, parent, **counts):
        nonlocal sid
        sid += 1
        ev.append({"name": name, "ph": "X", "ts": ts, "dur": 10.0,
                   "args": {"id": sid, "parent": parent, "call": 1,
                            **counts}})
        return sid
    call = add("serve.call", 0.0, None)
    for s in range(steps):
        step = add("serve.step", 1e6 * s, call, phase="decode", step=s)
        model = add("model.decode", 1e6 * s + 1, step, batch=tokens)
        for k in range(layers):
            add("model.moe", 1e6 * s + 2 + k, model, tokens=tokens,
                experts=64, k=8, routed=routed(s, k))
    return ev


def test_readers_without_spans_read_nothing():
    for ctx in ({"span_events": None, "span_devices": None},
                {"span_events": [], "span_devices": {}},
                {"span_events": _moe_events(4, 2, 16, lambda s, k: 50),
                 "span_devices": {"model.decode": {"launches": 9,
                                                   "device_s": 1.0}}}):
        ctx = {**ctx, "trace_steps": [1, 3], "config": tiny()}
        assert all(harness.load_metric(m)(ctx) is None for m in READERS)


def test_readers_on_a_synthetic_trace():
    cfg = cell.load(CELL)["config"]
    ev = _moe_events(6, 16, 16, lambda s, k: 40 + s + k)
    owned = {"model.decode": {"launches": 3000, "device_s": 0.02},
             "model.moe": {"launches": 1600, "device_s": 0.4}}
    ctx = {"span_events": ev, "span_devices": owned, "trace_steps": [2, 4],
           "config": cfg}
    read = {m: harness.load_metric(m)(ctx) for m in READERS}
    assert read["moe_device_ms_per_step"] == pytest.approx(200.0)
    assert read["moe_launches_per_step"] == pytest.approx(800.0)
    d, f = 2048, 1024
    want = sum(2 * ((40 + s + k) * 3 * d * f + d * 64 + 2 * 16 * d)
               for s in (2, 3) for k in range(16))
    assert moecounts.layer_bytes(cfg, 16, 42) == \
        2 * (42 * 3 * d * f + d * 64 + 2 * 16 * d)
    assert read["moe_roofline"] == pytest.approx(
        100 * want / 3.35e12 / 0.4)
    # a profiled layer whose routed count is missing leaves the share
    # unread; one outside the profiled steps does not count
    moes = [e for e in ev if e["name"] == "model.moe"]
    moes[-1]["args"].pop("routed")
    assert harness.load_metric("moe_roofline")(ctx) == \
        read["moe_roofline"]
    moes[2 * 16 + 3]["args"]["routed"] = None
    assert harness.load_metric("moe_roofline")(ctx) is None


def _mid_size_spec():
    """An OLMoE cell at the published head width, 4 layers of 8 experts
    top-2, in bfloat16, 4 sequences of 8 + 48 tokens: enough served
    tokens for the control's gaps to show."""
    spec = smoke.spec("serve_batch", "moe", "bfloat16")
    cfg = tiny("bfloat16")
    sizes = {"hidden_size": 512, "intermediate_size": 256,
             "num_attention_heads": 4, "num_key_value_heads": 4,
             "head_dim": 128, "vocab_size": 4096}
    cfg.update(sizes)
    cfg["port_overrides"].update(
        d_model=512, d_ff=256, num_heads=4, num_kv_heads=4, head_dim=128,
        vocab_size=4096)
    spec["config"] = cfg
    spec["traffic"].update(batch=4, calls=[[8, 48]], sample_sequences=4)
    return spec


def test_fp8_control_reads_far_above_the_program():
    spec = _mid_size_spec()
    for seed in (1, 2 ** 31 + 3):
        row = control.readings(spec, seed, "cpu")
        prog, ctrl = row["program"], row["control"]
        assert row["served"] == 4 * 48
        assert ctrl["logit_gap_mean"] > 3 * prog["logit_gap_mean"]
        assert ctrl["logit_gap"] > prog["logit_gap"]
        assert row["control_tokens_off"] > row["tokens_off"]
