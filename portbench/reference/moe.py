"""Plain PyTorch reference of a sparse mixture-of-experts decoder
(Qwen3-MoE's block).

The dense reference's attention block (per-head RMSNorm of q and k),
with the MLP replaced by routed experts: router logits over the experts,
the `num_experts_per_tok` largest chosen (equal logits go to the lower
expert index), weighted by the softmax over the chosen logits when
`norm_topk_prob` is true and by their softmax over all experts
otherwise; each chosen expert's SwiGLU computed only on the tokens
routed to it. Float32 with TF32 off. OLMoE's block normalises the whole
q and k projections instead of each head, which this reference does not
compute. Its leaves are the dense block's with the MLP's replaced by a
router and the experts' stacked SwiGLU weights.
"""
from __future__ import annotations

import functools

import torch

from portbench.reference import dense

F32 = torch.float32
FFN = ("router",) + dense.FFN


def expert_leaves(cfg, dtype) -> list:
    """The router's and the experts' stacked leaves (`dense.leaves`)."""
    layers, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    e, f = cfg["num_experts"], cfg["intermediate_size"]
    return [("router", (layers, d, e), d ** -0.5, dtype),
            ("w_gate", (layers, e, d, f), d ** -0.5, dtype),
            ("w_up", (layers, e, d, f), d ** -0.5, dtype),
            ("w_down", (layers, e, f, d), f ** -0.5, dtype)]


def leaves(cfg, vocab_rows: int) -> list:
    """The leaves the seed draws, in order (`dense.leaves`)."""
    return dense.leaves(cfg, vocab_rows, ffn=expert_leaves)


def port_params(w: dict) -> dict:
    """`w` in repro_torch's parameter tree (`dense.port_params`)."""
    return dense.port_params(w, FFN)


def route(w, cfg, layer, h):
    """(weights (N, k), experts (N, k)) for the flat tokens h (N, D)."""
    logit = dense.linear(h, w["router"][layer])
    k = cfg["num_experts_per_tok"]
    top, idx = torch.sort(logit, dim=-1, descending=True, stable=True)
    if cfg.get("norm_topk_prob", False):
        weight = top[:, :k].softmax(dim=-1)
    else:
        weight = logit.softmax(dim=-1).gather(1, idx[:, :k])
    return weight, idx[:, :k]


def experts(w, cfg, layer, h, quant=None):
    shape = h.shape
    h = h.reshape(-1, shape[-1])
    weight, idx = route(w, cfg, layer, h)
    out = torch.zeros_like(h)
    for e in torch.unique(idx).tolist():
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        x = h[tok]
        g = dense.linear(x, w["w_gate"][layer, e], quant)
        u = dense.linear(x, w["w_up"][layer, e], quant)
        y = dense.linear(torch.nn.functional.silu(g) * u,
                         w["w_down"][layer, e], quant)
        out.index_add_(0, tok, y * weight[tok, slot, None])
    return out.reshape(shape)


def logits(w, cfg, tokens, quant=None):
    return dense.logits(w, cfg, tokens, quant,
                        ffn=functools.partial(_ffn, cfg=cfg))


def _ffn(w, layer, h, quant, cfg):
    return experts(w, cfg, layer, h, quant)
