"""Work and bytes counted from shapes: the numerators of `step_mfu`,
`k1_roofline` and `k2_roofline`, and the H100's peaks they are held to.

Model FLOPs are the model's own work, whatever implements it: every
weight product of each new token (2 FLOPs per multiply-add), attention's
two products over the positions so far, and, in a mixture-of-experts
layer, the router and only the experts each token is routed to. The
embedding lookup, norms, rotary and softmax are not counted.

The kernels' bytes are what their inputs need, each byte read once and
each output written once (copied from the serve benchmark's bounds):
K1 (`residency_fused`) reads and writes every slot's 17 bytes of page
table metadata, reads the small per-lane and per-request arrays, moves
each landed page's K and V rows into the pool (read and written) and
gathers every request's rows (read and written); K2 (`paged_gather`,
the K and V pair) reads the index list, the hit mask and the missing
requests' rows, and writes every request's rows.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12

META_BYTES_PER_SLOT = 17          # page i32, age f32, ready f32, rrpv f32, dirty


def token_flops(cfg: dict, position: int) -> int:
    """FLOPs of one token at `position` (0-based) through the model."""
    d, layers = cfg["hidden_size"], cfg["num_hidden_layers"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, f = cfg["head_dim"], cfg["intermediate_size"]
    proj = 2 * d * hd * (nh + 2 * nkv) + 2 * nh * hd * d
    attn = 2 * 2 * nh * hd * (position + 1)
    if cfg["family"] == "moe":
        ffn = cfg["num_experts_per_tok"] * 3 * 2 * d * f \
            + 2 * d * cfg["num_experts"]
    else:
        ffn = 3 * 2 * d * f
    return layers * (proj + attn + ffn) + 2 * d * cfg["vocab_size"]


def call_flops(cfg: dict, batch: int, steps: int) -> int:
    """FLOPs of one call: `batch` sequences through positions 0..steps-1
    (the prompt runs through the decode cell too)."""
    return batch * sum(token_flops(cfg, t) for t in range(steps))


def row_bytes(geometry: dict) -> int:
    """Bytes of one page of K (or of V) in the store's pools, bf16."""
    return (geometry["page_tokens"] * geometry["kv_heads"]
            * geometry["head_dim"] * 2)


def k1_bytes(batch: int, slots: int, inflight: int, requests: int,
             row: int, landings: int) -> int:
    """K1's bytes in one launch: `slots` pool slots per sequence,
    `inflight` page-buffer lanes, `requests` per sequence, `landings`
    pages landed over the batch."""
    lanes = min(inflight, slots)
    meta = batch * slots * META_BYTES_PER_SLOT * 2
    small = (batch * inflight * 5 + batch * requests * 5 + batch * lanes * 4
             + batch * 4 + batch * requests + 16)
    rows = 2 * (2 * landings * row) + 2 * (2 * batch * requests * row)
    return meta + small + rows


def k2_bytes(lookups: int, misses: int, row: int,
             masked: bool = True) -> int:
    """K2's bytes in one launch of the K and V pair: `lookups` rows
    gathered, of which `misses` are read (all when unmasked)."""
    read = lookups if not masked else misses
    return (2 * read * row + 2 * lookups * row + 4 * lookups
            + (lookups if masked else 0))
