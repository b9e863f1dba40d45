"""GQA attention, decode path (one new token against a KV cache).

PyTorch counterpart of the decode half of ``repro.models.attention``,
written as the reference's math: project, RMS-normalise q and k, RoPE,
write the cache, expand the KV heads, scaled scores in f32, mask,
softmax, weighted sum, output projection. The KV cache keeps the
reference's (B, T, K, H) layout and is written in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import F32, apply_rope, dot, normal, rms_norm

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, *, layers: int = 0,
                   dtype=F32):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    p = {"wq": normal(gen, (d, nh, hd), layers=layers, dtype=dtype),
         "wk": normal(gen, (d, nkv, hd), layers=layers, dtype=dtype),
         "wv": normal(gen, (d, nkv, hd), layers=layers, dtype=dtype),
         "wo": normal(gen, (nh, hd, d), layers=layers, dtype=dtype)}
    if cfg.qk_norm:
        full = ((layers,) if layers else ()) + (hd,)
        p["q_norm"] = torch.zeros(full, dtype=F32, device=gen.device)
        p["k_norm"] = torch.zeros(full, dtype=F32, device=gen.device)
    return p


def _project_qkv(params, cfg, x, kv_x, positions, kv_positions, use_rope):
    dtype = x.dtype
    q = dot(x, params["wq"].to(dtype), "bsd,dnh->bsnh").to(dtype)
    k = dot(kv_x, params["wk"].to(dtype), "btd,dkh->btkh").to(dtype)
    v = dot(kv_x, params["wv"].to(dtype), "btd,dkh->btkh").to(dtype)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(t, cfg):
    """(B,T,K,H) -> (B,T,NH,H): broadcast KV heads to query heads."""
    group = cfg.num_heads // cfg.num_kv_heads
    if group == 1:
        return t
    return torch.repeat_interleave(t, group, dim=2)


def init_kv_cache(cfg, batch: int, max_len: int, device=None):
    """Zero KV cache for one layer, in cfg.dtype."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_attention(params, cfg, x, cache, pos: int, *, window: int = 0):
    """x: (B,1,D); cache {k,v}: (B,T,K,H), written IN PLACE at `pos`.
    Returns (y (B,1,D), cache)."""
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, x, positions, positions,
                                   use_rope=True)
    t = cache["k"].shape[1]
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    kx = _expand_kv(cache["k"], cfg)
    vx = _expand_kv(cache["v"], cfg)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    s = dot(q.to(F32), kx.to(F32), "bsnh,btnh->bnst") * scale  # (B,N,1,T)
    kpos = torch.arange(t, device=x.device)
    ok = kpos <= pos
    if window:
        ok &= (pos - kpos) < window
    s = s + torch.where(ok, 0.0, NEG_INF).to(F32)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    out = dot(p, vx, "bnst,btnh->bsnh").to(x.dtype)
    y = dot(out, params["wo"].to(x.dtype), "bsnh,nhd->bsd").to(x.dtype)
    return y, cache
