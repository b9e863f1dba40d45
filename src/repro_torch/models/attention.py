"""GQA attention: full-sequence (direct and blockwise flash-style) for
training, and decode (one new token against a KV cache).

PyTorch counterpart of ``repro.models.attention``, written as the
reference's math: project, RMS-normalise q and k (per head, or over
the whole projection with `qk_norm_width` "full"), RoPE, expand the KV
heads, scaled scores in f32, mask, softmax, weighted sum, output
projection; cross attention (whisper's decoder over its encoder) has
no RoPE and no q/k norms. The blockwise path keeps the reference's
running (m, l, acc) and its two tile orders (every KV block, or the
static causal/banded pair list); it is plain torch on purpose, held to
the reference, not ``scaled_dot_product_attention``. The KV cache
keeps the reference's (B, T, K, H) layout and is written in place.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.models.layers import (F32, apply_rope, dot, normal,
                                       reduced, rms_norm)
from repro_torch.runtime.mesh_rules import constrain, run_local

NEG_INF = -1e30


def _qk_norm_widths(cfg):
    """(q_norm width, k_norm width): one head's (`qk_norm_width` "head")
    or the whole projection's ("full")."""
    hd = cfg.resolved_head_dim
    if cfg.qk_norm_width == "head":
        return hd, hd
    if cfg.qk_norm_width == "full":
        return cfg.num_heads * hd, cfg.num_kv_heads * hd
    raise ValueError(f"qk_norm_width must be head|full, got "
                     f"{cfg.qk_norm_width!r}")


def init_attention(gen: torch.Generator, cfg, *, cross: bool = False,
                   layers: int = 0, dtype=F32):
    """Projections wq (D,NH,H), wk/wv (D,K,H), wo (NH,H,D) in `dtype`;
    with cfg.qk_norm, f32 q_norm/k_norm scales ((H,) each, or (NH*H,) and
    (K*H,) with `qk_norm_width` "full"), which a cross-attention block
    (`cross`) does not have."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    p = {"wq": normal(gen, (d, nh, hd), layers=layers, dtype=dtype),
         "wk": normal(gen, (d, nkv, hd), layers=layers, dtype=dtype),
         "wv": normal(gen, (d, nkv, hd), layers=layers, dtype=dtype),
         "wo": normal(gen, (nh, hd, d), layers=layers, dtype=dtype)}
    if cfg.qk_norm and not cross:
        lead = (layers,) if layers else ()
        qw, kw = _qk_norm_widths(cfg)
        p["q_norm"] = torch.zeros(lead + (qw,), dtype=F32, device=gen.device)
        p["k_norm"] = torch.zeros(lead + (kw,), dtype=F32, device=gen.device)
    return p


def attention_axes(cfg, *, cross: bool = False):
    """Logical axes of `init_attention`'s parameters; the q/k norm scales
    are replicated at either width."""
    a = {"wq": ("fsdp", "tensor", None), "wk": ("fsdp", "tensor_kv", None),
         "wv": ("fsdp", "tensor_kv", None), "wo": ("tensor", None, "fsdp")}
    if cfg.qk_norm and not cross:
        a["q_norm"] = (None,)
        a["k_norm"] = (None,)
    return a


def qk_norm(t, scale, cfg):
    """RMSNorm of q or k (B,T,N,H) with its scale, per head or, with
    `qk_norm_width` "full", over the whole N*H projection (the same
    element order, so a view); eps `cfg.norm_eps`."""
    if cfg.qk_norm_width == "full":
        return rms_norm(t.flatten(-2), scale, cfg.norm_eps).view(t.shape)
    return rms_norm(t, scale, cfg.norm_eps)


def _project_qkv(params, cfg, x, kv_x, positions, kv_positions, use_rope):
    dtype = x.dtype
    q = dot(x, params["wq"].to(dtype), "bsd,dnh->bsnh").to(dtype)
    k = dot(kv_x, params["wk"].to(dtype), "btd,dkh->btkh").to(dtype)
    v = dot(kv_x, params["wv"].to(dtype), "btd,dkh->btkh").to(dtype)
    if "q_norm" in params:
        q = qk_norm(q, params["q_norm"], cfg)
        k = qk_norm(k, params["k_norm"], cfg)
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


def _mask_bias(qpos, kpos, causal: bool, window: int):
    """(len(qpos), len(kpos)) additive mask in f32."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= qpos[:, None] >= kpos[None, :]
    if window:
        ok &= (qpos[:, None] - kpos[None, :]) < window
    return torch.where(ok, 0.0, NEG_INF).to(F32)


def _direct_attention(q, k, v, qpos, kpos, causal, window):
    """q: (B,S,N,H); k,v: (B,T,N,H) (already head-expanded)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = dot(q, k, "bsnh,btnh->bnst") * scale            # f32
    s = s + _mask_bias(qpos, kpos, causal, window)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return dot(p, v, "bnst,btnh->bsnh").to(q.dtype)


def _pick_block(t: int, target: int = 1024) -> int:
    for b in range(min(target, t), 0, -1):
        if t % b == 0:
            return b
    return t


def _online_update(q, ks, vs, qp, kp, m, l, acc, causal, window, scale):
    """One (q-block, kv-block) tile of the running softmax: returns the
    block's new (m (B,N,s), l (B,N,s), acc (B,s,N,H) f32)."""
    sc = dot(q, ks, "bsnh,btnh->bnst") * scale
    sc = sc + _mask_bias(qp, kp, causal, window)
    m_new = torch.maximum(m, sc.amax(dim=-1))
    p = torch.exp(sc - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = dot(p.to(q.dtype), vs, "bnst,btnh->bsnh")
    acc = acc * corr.permute(0, 2, 1)[..., None] + pv
    return m_new, l, acc


def _flash_attention(q, k, v, qpos, kpos, causal, window,
                     kv_block: int = 1024, triangular: bool = True):
    """Blockwise attention with running (m, l, acc): O(S*block) memory.

    triangular=True visits only the (q-block, kv-block) tiles a causal
    (optionally banded) mask can reach, in the reference's static pair
    order. Each q block carries its own running state (the reference
    updates slices of one array; the values are the same), which keeps
    the loop free of in-place writes for autograd.
    """
    b, s, nh, hd = q.shape
    t = k.shape[1]
    blk = _pick_block(t, kv_block)
    nblk = t // blk
    scale = 1.0 / math.sqrt(hd)

    def init(rows):
        return (torch.full((b, nh, rows), -math.inf, dtype=F32,
                           device=q.device),
                torch.zeros((b, nh, rows), dtype=F32, device=q.device),
                torch.zeros((b, rows, nh, hd), dtype=F32, device=q.device))

    def finish(l, acc):
        l = torch.clamp(l, min=1e-30)
        return (acc / l.permute(0, 2, 1)[..., None]).to(q.dtype)

    if not (triangular and causal):
        m, l, acc = init(s)
        for i in range(nblk):
            sl = slice(i * blk, (i + 1) * blk)
            m, l, acc = _online_update(q, k[:, sl], v[:, sl], qpos, kpos[sl],
                                       m, l, acc, causal, window, scale)
        return finish(l, acc)

    # ---- triangular / banded tile enumeration (static pair list) ----
    qblk = _pick_block(s, kv_block)
    nq = s // qblk
    state = [init(qblk) for _ in range(nq)]
    for qi in range(nq):
        for kj in range(nblk):
            lo_q, hi_q = qi * qblk, (qi + 1) * qblk - 1
            lo_k = kj * blk
            if lo_k > hi_q:            # fully above the causal diagonal
                continue
            if window and (lo_q - (kj + 1) * blk + 1) >= window:
                continue               # fully outside the band
            qs = slice(qi * qblk, (qi + 1) * qblk)
            ks = slice(kj * blk, (kj + 1) * blk)
            state[qi] = _online_update(q[:, qs], k[:, ks], v[:, ks],
                                       qpos[qs], kpos[ks], *state[qi], True,
                                       window, scale)
    return torch.cat([finish(l, acc) for _, l, acc in state], dim=1)


def attention(params, cfg, x, *, kv_x=None, positions=None,
              kv_positions=None, causal=True, window=0,
              flash_threshold=2048, triangular=True, reduce_dtype=None):
    """Full-sequence attention (training / prefill). x: (B,S,D).
    `reduce_dtype` is the output projection's product dtype (default
    f32), which sets the width of its tensor-parallel all-reduce on
    DTensors (`layers.reduced`)."""
    b, s, _ = x.shape
    cross = kv_x is not None
    kv_in = kv_x if cross else x
    t = kv_in.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if kv_positions is None:
        kv_positions = torch.arange(t, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, kv_in, positions, kv_positions,
                           use_rope=not cross)
    k = _expand_kv(k, cfg)
    v = _expand_kv(v, cfg)
    q = constrain(q, ("batch", None, "tensor", None))
    k = constrain(k, ("batch", None, "tensor", None))
    v = constrain(v, ("batch", None, "tensor", None))
    if max(s, t) > flash_threshold:
        core = functools.partial(_flash_attention, triangular=triangular)
    else:
        core = _direct_attention
    # on DTensors split over batch and heads only (the constraint above):
    # every rank attends over its own shards, as a partitioner would
    out = run_local(core, (q, k, v),
                    (positions, kv_positions, causal and not cross, window))
    # row-parallel output: reduced at the product's dtype, then cast
    y = dot(out, params["wo"].to(x.dtype), "bsnh,nhd->bsd",
            out_dtype=reduce_dtype or F32)
    return reduced(y).to(x.dtype)


def init_kv_cache(cfg, batch: int, max_len: int, device=None):
    """Zero KV cache for one layer, in cfg.dtype."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def kv_cache_axes(kv_seq_axis: str = "kv_seq"):
    """Logical axes of one layer's KV cache; `kv_seq_axis` names the
    sequence axis ("kv_seq", or "long_seq" for long-context decode)."""
    ax = ("batch", kv_seq_axis, "tensor_kv", None)
    return {"k": ax, "v": ax}


def decode_attention(params, cfg, x, cache, pos: int, *, window: int = 0,
                     ring: bool = False):
    """x: (B,1,D); cache {k,v}: (B,T,K,H), written IN PLACE at `pos`.
    Returns (y (B,1,D), cache).

    ring=True (windowed archs): the cache holds only the last T tokens
    and the write lands at pos % T. RoPE is applied at write time with
    absolute positions and every resident entry is within the window by
    construction, so the mask is only the warm-up's kpos <= pos."""
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, x, positions, positions,
                                   use_rope=True)
    t = cache["k"].shape[1]
    write_at = pos % t if ring else pos
    cache["k"][:, write_at] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, write_at] = v_new[:, 0].to(cache["v"].dtype)
    kx = _expand_kv(cache["k"], cfg)
    vx = _expand_kv(cache["v"], cfg)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    s = dot(q, kx, "bsnh,btnh->bnst") * scale                  # (B,N,1,T)
    kpos = torch.arange(t, device=x.device)
    ok = kpos <= pos
    if window and not ring:
        ok &= (pos - kpos) < window
    s = s + torch.where(ok, 0.0, NEG_INF).to(F32)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    out = dot(p, vx, "bnst,btnh->bsnh").to(x.dtype)
    y = dot(out, params["wo"].to(x.dtype), "bsnh,nhd->bsd").to(x.dtype)
    return y, cache


def decode_cross_attention(params, cfg, x, cross_kv):
    """Cross attention of one new token x (B,1,D) over the static encoder
    KV cross_kv {k, v} (B,T,K,H): no RoPE, no mask. Returns (B,1,D)."""
    q = dot(x, params["wq"].to(x.dtype), "bsd,dnh->bsnh").to(x.dtype)
    kx = _expand_kv(cross_kv["k"].to(x.dtype), cfg)
    vx = _expand_kv(cross_kv["v"].to(x.dtype), cfg)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    s = dot(q, kx, "bsnh,btnh->bnst") * scale
    p = torch.softmax(s, dim=-1).to(x.dtype)
    out = dot(p, vx, "bnst,btnh->bsnh").to(x.dtype)
    return dot(out, params["wo"].to(x.dtype), "bsnh,nhd->bsd").to(x.dtype)
