"""Mixture-of-Experts: top-k routing and the dense combine.

PyTorch counterpart of the dense path of ``repro.models.moe``:
`init_moe`, `_route`, `moe_dense` and `moe`. Every expert runs on every
token and the combine masks by the routing weights, as the reference's
oracle does. Its expert-parallel path (`moe_ep`: tokens sort-grouped by
shard, `all_to_all` over a mesh axis) needs the multi-device plane and
raises.

Top-k ties go to the lower expert index, as `jax.lax.top_k` breaks them:
the k experts are the first k of a stable descending sort, which orders
alike on the CPU and on the card (`torch.topk` does not promise an order
among equal values).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import F32, dot, normal, silu


def init_moe(gen: torch.Generator, cfg, *, layers: int = 0, dtype=F32):
    """Router (D, E) and the experts' SwiGLU weights (E, D, F), (E, D, F),
    (E, F, D), each drawn at the reference's scale (1/sqrt of the leading
    dimension; 0.02 for the router); `layers` > 0 stacks them."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": normal(gen, (d, e), scale=0.02, layers=layers,
                             dtype=dtype),
            "w_gate": normal(gen, (e, d, f), layers=layers, dtype=dtype),
            "w_up": normal(gen, (e, d, f), layers=layers, dtype=dtype),
            "w_down": normal(gen, (e, f, d), layers=layers, dtype=dtype)}


def top_k_lowest_first(x, k: int):
    """(values, indices) of the k largest entries of the last axis, in
    descending order, equal values by ascending index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, cfg, x):
    """Returns (weights (B,S,k) f32, idx (B,S,k) int64, aux_loss scalar):
    softmax over the k largest router logits, and the Switch-style
    load-balance loss E * sum_e importance_e * load_e."""
    logits = dot(x, params["router"].to(x.dtype), "bsd,de->bse")
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    top_w, top_i = top_k_lowest_first(logits, k)
    top_w = torch.softmax(top_w, dim=-1)
    e = cfg.num_experts
    importance = probs.mean(dim=(0, 1))
    flat = top_i.reshape(-1)
    # integer-valued f32 sums are exact in any order; bincount would read
    # the largest index back to the host
    counts = torch.zeros((e,), dtype=F32, device=x.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=F32, device=x.device))
    load = counts / top_i.numel()
    aux = e * torch.sum(importance * load)
    return top_w, top_i, aux


def moe_dense(params, cfg, x):
    """All experts on all tokens, masked combine. x (B,S,D) -> ((B,S,D),
    aux)."""
    dtype = x.dtype
    w, idx, aux = _route(params, cfg, x)
    e = cfg.num_experts
    experts = torch.arange(e, device=x.device)
    gates = ((idx[..., None] == experts).to(F32) * w[..., None]).sum(-2)
    g = dot(x, params["w_gate"].to(dtype), "bsd,edf->bsef")
    u = dot(x, params["w_up"].to(dtype), "bsd,edf->bsef")
    h = (silu(g) * u).to(dtype)
    y = dot(h, params["w_down"].to(dtype), "bsef,efd->bsed")
    y = (y * gates[..., None]).sum(dim=2)
    return y.to(dtype), aux


def moe(params, cfg, x, impl: str = "dense"):
    if impl == "ep":
        raise NotImplementedError(
            "moe(impl='ep') is expert parallelism over a device mesh, "
            "which is not ported yet (ROADMAP Queue 1 item 9)")
    if impl != "dense":
        raise ValueError(f"moe impl must be dense|ep, got {impl!r}")
    return moe_dense(params, cfg, x)
