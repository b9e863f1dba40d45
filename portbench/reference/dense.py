"""Plain PyTorch reference of a dense decoder (Qwen3's block).

Written from the published architecture, in float32 with TF32 off: token
embedding; per layer RMSNorm, grouped-query attention with per-head
RMSNorm of q and k and rotary embeddings over (first half, second half)
pairs, causal softmax over the positions so far, the output projection
and a residual add, then RMSNorm, the SwiGLU MLP and a residual add; a
final RMSNorm and the output head over the logical vocabulary (the
embedding table itself where the configuration ties them). Each
RMSNorm's weight is stored as an offset from 1. The whole sequence is
computed at once, with no cache and no batching tricks.

The module also says what the benchmark draws from the seed for this
block and where the port takes it: `leaves(cfg, vocab_rows)`, the flat
weight dict's leaves in the order they are drawn, and
`port_params(weights)`, the same tensors in repro_torch's parameter
tree. `logits(weights, cfg, tokens)` reads that dict and the
configuration file's published keys; `quant="fp8"` fake-quantises both
operands of every weight product to float8 e4m3 (per row of the
activations, per output column of the weights): the lower-precision
control.
"""
from __future__ import annotations

import contextlib

import torch

F32 = torch.float32
FP8_MAX = 448.0
FFN = ("w_gate", "w_up", "w_down")


def mlp_leaves(cfg, dtype) -> list:
    """The SwiGLU MLP's stacked leaves (see `leaves`)."""
    layers, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    f = cfg["intermediate_size"]
    return [("w_gate", (layers, d, f), d ** -0.5, dtype),
            ("w_up", (layers, d, f), d ** -0.5, dtype),
            ("w_down", (layers, f, d), f ** -0.5, dtype)]


def leaves(cfg, vocab_rows: int, ffn=mlp_leaves) -> list:
    """(name, shape, scale, dtype) of each leaf, in the order the seed
    draws them, each a standard normal times `scale`: projections
    stacked over the layers in the served type at 1/sqrt(fan-in), the
    embedding (`vocab_rows`, the port's padded table) at 1, the RMSNorm
    offsets in float32 at 0.1, `ffn(cfg, dtype)`'s leaves after the
    second norm, the output head last at 1/sqrt(d). The untied model's:
    with `tie_word_embeddings` the harness draws one table as the head
    is drawn, in the embedding's place, and hands it to both."""
    dtype = getattr(torch, cfg["torch_dtype"])
    layers, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["head_dim"]
    return [("embed", (vocab_rows, d), 1.0, dtype),
            ("norm1", (layers, d), 0.1, F32),
            ("wq", (layers, d, nh, hd), d ** -0.5, dtype),
            ("wk", (layers, d, nkv, hd), d ** -0.5, dtype),
            ("wv", (layers, d, nkv, hd), d ** -0.5, dtype),
            ("wo", (layers, nh, hd, d), (nh * hd) ** -0.5, dtype),
            ("q_norm", (layers, hd), 0.1, F32),
            ("k_norm", (layers, hd), 0.1, F32),
            ("norm2", (layers, d), 0.1, F32),
            *ffn(cfg, dtype),
            ("final_norm", (d,), 0.1, F32),
            ("unembed", (vocab_rows, d), d ** -0.5, dtype)]


def port_params(w: dict, ffn=FFN) -> dict:
    """`w`'s tensors in repro_torch's parameter tree (one stacked run of
    attention blocks, the feed-forward leaves `ffn`), without copies."""
    run = {"norm1": {"scale": w["norm1"]},
           "attn": {k: w[k] for k in ("wq", "wk", "wv", "wo", "q_norm",
                                      "k_norm")},
           "norm2": {"scale": w["norm2"]},
           "ffn": {k: w[k] for k in ffn}}
    return {"embed": {"table": w["embed"]}, "runs": (run,),
            "final_norm": {"scale": w["final_norm"]},
            "unembed": {"table": w["unembed"]}}


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the duration (restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` rounded through float8 e4m3 with one scale per slice along
    `dim` (its absolute maximum at 448)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(F32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """x (..., K) f32 @ w (K, N) in f32; `quant="fp8"` rounds x per row
    and w per column through float8 first."""
    w = w.to(F32)
    if quant == "fp8":
        x, w = fp8(x, -1), fp8(w, 0)
    return x @ w


def rms_norm(x, offset, eps):
    x = x.to(F32)
    y = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return y * (1.0 + offset.to(F32))


def rotary(x, positions, theta):
    """x (S, T, H, D): rotate the (first half, second half) pairs by
    position * theta^(-i / (D/2))."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[:, None] * inv[None, :]           # (T, half)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(w, cfg, layer, h, quant):
    s, t, d = h.shape
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps = cfg["head_dim"], cfg["rms_norm_eps"]
    q = linear(h, w["wq"][layer].reshape(d, nh * hd), quant)
    k = linear(h, w["wk"][layer].reshape(d, nkv * hd), quant)
    v = linear(h, w["wv"][layer].reshape(d, nkv * hd), quant)
    q = rms_norm(q.view(s, t, nh, hd), w["q_norm"][layer], eps)
    k = rms_norm(k.view(s, t, nkv, hd), w["k_norm"][layer], eps)
    v = v.view(s, t, nkv, hd)
    pos = torch.arange(t, device=h.device)
    q = rotary(q, pos, cfg["rope_theta"])
    k = rotary(k, pos, cfg["rope_theta"])
    group = nh // nkv
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    scores = torch.einsum("sqnh,sknh->snqk", q, k) / hd ** 0.5
    causal = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.einsum("snqk,sknh->sqnh", scores.softmax(dim=-1), v)
    return linear(out.reshape(s, t, nh * hd),
                  w["wo"][layer].reshape(nh * hd, d), quant)


def mlp(w, layer, h, quant):
    g = linear(h, w["w_gate"][layer], quant)
    u = linear(h, w["w_up"][layer], quant)
    return linear(torch.nn.functional.silu(g) * u, w["w_down"][layer],
                  quant)


def logits(w, cfg, tokens, quant=None, ffn=mlp, vocab_block=32768):
    """tokens (S, T) -> logits (S, T, vocab_size) f32."""
    eps = cfg["rms_norm_eps"]
    with exact_f32(), torch.no_grad():
        x = w["embed"][tokens.long()].to(F32)
        for layer in range(cfg["num_hidden_layers"]):
            h = rms_norm(x, w["norm1"][layer], eps)
            x = x + attention(w, cfg, layer, h, quant)
            h = rms_norm(x, w["norm2"][layer], eps)
            x = x + ffn(w, layer, h, quant)
        x = rms_norm(x, w["final_norm"], eps)
        head = w["embed"] if cfg.get("tie_word_embeddings") else \
            w["unembed"]
        out = [linear(x, head[i:i + vocab_block].T, quant)
               for i in range(0, cfg["vocab_size"], vocab_block)]
        return torch.cat(out, dim=-1)[..., :cfg["vocab_size"]]
