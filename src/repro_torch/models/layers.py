"""Shared layer primitives: parameter init, RMSNorm, RoPE, SwiGLU MLP,
the softmax cross entropy.

PyTorch counterpart of ``repro.models.layers``. Parameters are plain
dicts of tensors in the reference's layout; a stacked run of layers
carries a leading (L,) axis. Initialisation draws from an explicit
``torch.Generator``: the numbers differ from ``jax.random``, so tests move
the reference's parameters over with ``repro_torch.convert`` instead.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


# --------------------------------------------------------------------------
# param construction
# --------------------------------------------------------------------------
def normal(gen: torch.Generator, shape, *, scale=None, layers: int = 0,
           dtype=F32) -> torch.Tensor:
    """N(0, scale^2) weights (default scale 1/sqrt(shape[0])), drawn in f32
    on the generator's device and cast to `dtype`; `layers` > 0 prepends
    a stacked (L,) axis with the per-layer scale. A stacked leaf is
    allocated once in `dtype` and filled one layer at a time from an f32
    draw scaled in place, so the f32 transient is one layer, not the
    stack."""
    s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    shape = tuple(shape)
    out = torch.empty(((layers,) if layers else ()) + shape, dtype=dtype,
                      device=gen.device)
    for layer in out.view((-1,) + shape):
        layer.copy_(torch.randn(shape, generator=gen, dtype=F32,
                                device=gen.device).mul_(s))
    return out


def zeros(shape, *, layers: int = 0, device=None) -> torch.Tensor:
    full = ((layers,) if layers else ()) + tuple(shape)
    return torch.zeros(full, dtype=F32, device=device)


def ones(shape, *, layers: int = 0, device=None) -> torch.Tensor:
    full = ((layers,) if layers else ()) + tuple(shape)
    return torch.ones(full, dtype=F32, device=device)


def init_rms_norm(dim: int, *, layers: int = 0, device=None):
    return {"scale": zeros((dim,), layers=layers, device=device)}


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=F32):
    return {"table": normal(gen, (padded_vocab(vocab), d_model), scale=1.0,
                            dtype=dtype)}


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
             layers: int = 0, dtype=F32):
    return {"w_gate": normal(gen, (d_model, d_ff), layers=layers,
                             dtype=dtype),
            "w_up": normal(gen, (d_model, d_ff), layers=layers, dtype=dtype),
            "w_down": normal(gen, (d_ff, d_model), layers=layers,
                             dtype=dtype)}


# --------------------------------------------------------------------------
# numerics
# --------------------------------------------------------------------------
def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm in f32, output in x.dtype."""
    xf = x.to(F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(F32))).to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


def dot(a, b, spec):
    """einsum with f32 accumulation, returned as f32. On f32 inputs this
    is the reference's f32 product; on bf16 inputs the GEMM accumulates
    in f32 and rounds its output to bf16 once before the widening."""
    return torch.einsum(spec, a, b).to(F32)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=F32, device=device)
                     / half)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, n_heads, head_dim); positions: (seq,). Rotates the
    (first half, second half) pairs."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].to(F32) * freqs     # (seq, half)
    angles = angles[..., None, :]                     # (seq, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------
def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def padded_vocab(vocab_size: int) -> int:
    """Physical vocab rows, padded to a multiple of 512 as the reference
    pads them; the logical vocab stays cfg.vocab_size."""
    return round_up(vocab_size, 512)


def embed(params, tokens, dtype):
    return params["table"][tokens].to(dtype)


def unembed(params, x):
    """Logits in f32 over the padded vocab."""
    return dot(x, params["table"].to(x.dtype), "bsd,vd->bsv")


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------
def mlp(params, x):
    dtype = x.dtype
    g = dot(x, params["w_gate"].to(dtype), "bsd,df->bsf")
    u = dot(x, params["w_up"].to(dtype), "bsd,df->bsf")
    h = (silu(g) * u).to(dtype)
    return dot(h, params["w_down"].to(dtype), "bsf,fd->bsd").to(dtype)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def softmax_xent(logits, labels, mask=None, z_loss: float = 1e-4):
    """Cross entropy with optional z-loss; logits (B,S,V) taken in f32,
    labels (B,S) int; `mask` (B,S) weights the mean."""
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    if mask is None:
        return loss.mean()
    mask = mask.to(F32)
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
