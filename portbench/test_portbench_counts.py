"""The FLOP and byte counts behind `step_mfu`, `k1_roofline` and
`k2_roofline`, held to the published shapes and to the serve
benchmark's bounds."""
from __future__ import annotations

import json

import pytest

from portbench import counts
from portbench.cell import HERE


def _cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_qwen3_token_flops_from_published_shapes():
    # Qwen3-1.7B: per layer q (2048 x 16 x 128), k and v (2048 x 8 x 128),
    # o (16 x 128 x 2048), SwiGLU 3 x 2048 x 6144; 28 layers; the head
    # 2048 x 151936 (tied to the embedding, a product all the same)
    per_layer = 2048 * 128 * 32 + 16 * 128 * 2048 + 3 * 2048 * 6144
    assert per_layer == 50_331_648
    matmul = 28 * per_layer + 2048 * 151936
    cfg = _cfg("qwen3-1.7b")
    for pos in (0, 63):
        attn = 28 * 2 * 2 * 16 * 128 * (pos + 1)
        assert counts.token_flops(cfg, pos) == 2 * matmul + attn
    assert counts.call_flops(cfg, 16, 64) == 16 * sum(
        counts.token_flops(cfg, t) for t in range(64))


def test_olmoe_counts_eight_of_sixty_four_experts():
    # OLMoE-1B-7B's published shapes (allenai/OLMoE-1B-7B-0924)
    cfg = {"family": "moe", "hidden_size": 2048, "num_hidden_layers": 16,
           "num_attention_heads": 16, "num_key_value_heads": 16,
           "head_dim": 128, "intermediate_size": 1024, "vocab_size": 50304,
           "num_experts": 64, "num_experts_per_tok": 8}
    all_experts = dict(cfg, num_experts_per_tok=64)
    one_expert = 16 * 3 * 2 * 2048 * 1024
    gap = counts.token_flops(all_experts, 0) - counts.token_flops(cfg, 0)
    assert gap == 56 * one_expert
    # the published model's 1.3 B active parameters, less the embedding
    active = counts.token_flops(cfg, 0) / 2
    assert 1.1e9 < active < 1.3e9


@pytest.mark.parametrize("row,bound_ms", [(16384, 0.000626),
                                          (81920, 0.00313)])
def test_k2_bytes_are_the_serve_benchmarks_bound(row, bound_ms):
    # PERF.md §6: the K and V pair, L = 32, unmasked, 16 and 80 KB rows
    nbytes = counts.k2_bytes(32, 32, row, masked=False)
    assert nbytes == 4 * 32 * row + 32 * 4
    assert nbytes / counts.HBM_BYTES_PER_S * 1e3 == pytest.approx(
        bound_ms, abs=5e-7)


def test_k2_bytes_read_only_the_misses():
    full = counts.k2_bytes(64, 64, 32768)
    none = counts.k2_bytes(64, 0, 32768)
    assert full - none == 2 * 64 * 32768
    assert none == 2 * 64 * 32768 + 5 * 64


def test_k1_bytes_at_the_serve_shape():
    # PERF.md §6: K1 at the serve shapes (8 sequences, 256 x 16 slots,
    # 256 in-flight lanes, 4 requests, 16-80 KB rows) is bound at
    # 0.000984-0.00357 ms; qwen3-1.7b's 32 KB rows with no landing:
    nbytes = counts.k1_bytes(8, 4096, 256, 4, 32768, 0)
    assert nbytes == (8 * 4096 * 17 * 2
                      + 8 * 256 * 5 + 8 * 4 * 5 + 8 * 256 * 4 + 8 * 4 + 8 * 4
                      + 16 + 2 * 2 * 8 * 4 * 32768)
    assert 0.000984 <= nbytes / counts.HBM_BYTES_PER_S * 1e3 <= 0.00357
    # each landed page moves its K and V row in and out once
    assert counts.k1_bytes(8, 4096, 256, 4, 32768, 3) - nbytes == \
        3 * 4 * 32768


def test_row_bytes():
    g = _cfg("qwen3-1.7b")["store"]
    assert counts.row_bytes(g) == 16 * 8 * 128 * 2
