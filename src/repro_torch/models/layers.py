"""Shared layer primitives: parameter init, RMSNorm, RoPE, SwiGLU MLP,
the softmax cross entropy.

PyTorch counterpart of ``repro.models.layers``. Parameters are plain
dicts of tensors in the reference's layout; a stacked run of layers
carries a leading (L,) axis. Initialisation draws from an explicit
``torch.Generator``: the numbers differ from ``jax.random``, so tests move
the reference's parameters over with ``repro_torch.convert`` instead.

Each family also states its parameters' *logical axes* (`*_axes`
functions): a tree of the parameters' structure whose leaves are tuples
of logical axis names, one per dimension, which
``runtime.mesh_rules`` maps onto a mesh. `ParamBuilder` and
`stack_layers` build a (params, axes) pair together, as the reference's
do.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.compute_plane import tree_leaves, tree_map
from repro_torch.runtime.mesh_rules import (constrain, is_axes_leaf,
                                            is_dtensor, named_sharding,
                                            outside_fake_mode)

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


class ParamBuilder:
    """Accumulates (params, axes) pairs, drawing from one generator in
    the order the leaves are added (the reference's `ParamBuilder`,
    whose split PRNG keys become draws from `gen`)."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen
        self.params = {}
        self.axes = {}

    def add(self, name, shape, axes, *, scale=None, init: str = "normal",
            dtype=F32):
        if len(axes) != len(shape):
            raise ValueError(f"{name}: axes {tuple(axes)} and shape "
                             f"{tuple(shape)} disagree")
        dev = self.gen.device
        if init == "zeros":
            v = torch.zeros(tuple(shape), dtype=dtype, device=dev)
        elif init == "ones":
            v = torch.ones(tuple(shape), dtype=dtype, device=dev)
        elif init == "normal":
            v = normal(self.gen, shape, scale=scale, dtype=dtype)
        elif init == "uniform":
            s = scale if scale is not None else 1.0 / math.sqrt(shape[0])
            v = (torch.rand(tuple(shape), generator=self.gen, dtype=F32,
                            device=dev) * (2 * s) - s).to(dtype)
        else:
            raise ValueError(init)
        self.params[name] = v
        self.axes[name] = tuple(axes)
        return v

    def sub(self, name, init_fn, *args, **kw):
        """`init_fn(gen, *args, **kw)` -> (params, axes) under `name`."""
        p, a = init_fn(self.gen, *args, **kw)
        self.params[name] = p
        self.axes[name] = a
        return p

    def build(self):
        return self.params, self.axes


def map_axes(fn, tree):
    """Map `fn` over the axes leaves of a tree of dicts, tuples and
    lists."""
    if is_axes_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_axes(fn, v) for v in tree)
    raise TypeError(f"not an axes tree: {type(tree).__name__}")


def stacked_axes(axes, n: int = 1):
    """`axes` with `n` leading "layers" axes (never sharded)."""
    return map_axes(lambda a: ("layers",) * n + a, axes)


def stack_layers(gen: torch.Generator, init_fn, n: int, *args, **kw):
    """`n` layers of `init_fn(gen, *args, **kw)` -> (params, axes) stacked
    on a leading (n,) axis, axes with a leading "layers" axis. Layers are
    drawn one at a time, in order, and copied into the stack, so the
    transient is one layer, not a second stack."""
    first, axes = init_fn(gen, *args, **kw)
    leaves = []

    def alloc(t):
        out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        out[0].copy_(t)
        leaves.append(out)
        return out

    params = tree_map(alloc, first)
    del first
    for i in range(1, n):
        layer, _ = init_fn(gen, *args, **kw)
        for out, t in zip(leaves, tree_leaves(layer)):
            out[i].copy_(t)
    return params, stacked_axes(axes)


def zeros(shape, *, layers: int = 0, device=None) -> torch.Tensor:
    full = ((layers,) if layers else ()) + tuple(shape)
    return torch.zeros(full, dtype=F32, device=device)


def ones(shape, *, layers: int = 0, device=None) -> torch.Tensor:
    full = ((layers,) if layers else ()) + tuple(shape)
    return torch.ones(full, dtype=F32, device=device)


def init_rms_norm(dim: int, *, layers: int = 0, device=None):
    return {"scale": zeros((dim,), layers=layers, device=device)}


def rms_norm_axes():
    return {"scale": (None,)}


def embedding_axes():
    return {"table": ("vocab", "fsdp")}


def mlp_axes():
    return {"w_gate": ("fsdp", "tensor"), "w_up": ("fsdp", "tensor"),
            "w_down": ("tensor", "fsdp")}


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


def dot(a, b, spec, out_dtype=F32):
    """einsum with f32 accumulation, returned as `out_dtype` (the
    reference's `preferred_element_type`). For f32 the operands are
    widened to f32 first: a bf16 x bf16 product is exact in f32, so the
    result is the f32 sum of the exact products, never a bf16-rounded
    GEMM output (f32 products do not use TF32 unless the caller turns
    `torch.backends.cuda.matmul.allow_tf32` on). A narrower `out_dtype`
    (bf16, `ModelOptions.tp_reduce_bf16`) is the product in the operands'
    dtype rounded once to it: on f32 operands the f32 product rounded,
    as XLA computes it; on bf16 operands the GEMM's own bf16 output."""
    if out_dtype == F32:
        return torch.einsum(spec, a.to(F32), b.to(F32))
    return torch.einsum(spec, a, b).to(out_dtype)


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
    table = params["table"]
    if is_dtensor(table):
        return _embed_local_map(table, tokens).to(dtype)
    return table[tokens].to(dtype)


def _embed_local_map(table, tokens):
    """`table[tokens]` on DTensors under ``local_map``: the table is
    gathered whole on every rank (an all-gather) and each rank looks up
    its own tokens; the table's gradient is a partial sum over the mesh
    axes that split the tokens. (DTensor's rule for the gradient of an
    indexed lookup, `index_put`, fails on some torch versions.)"""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    tok = tuple(tokens.placements)
    whole = tuple(Replicate() for _ in tok)
    grad = tuple(Partial() if p.is_shard() else Replicate() for p in tok)
    with outside_fake_mode():
        return local_map(lambda t, ids: t[ids], out_placements=(tok,),
                         in_placements=(whole, tok),
                         in_grad_placements=(grad, tok),
                         device_mesh=table.device_mesh,
                         redistribute_inputs=True)(table, tokens.long())


def unembed(params, x):
    """Logits in f32 over the padded vocab."""
    table = params["table"]
    if is_dtensor(table):
        return _unembed_local_map(table, x)
    return dot(x, table.to(x.dtype), "bsd,vd->bsv")


def _unembed_local_map(table, x):
    """`unembed` on DTensors under ``local_map``: the tokens split over
    the batch axes, the table over the vocab, the table gathered over
    its other axes; each rank computes its block of the logits, split
    as ("batch", None, "vocab"). The gradients are partial sums over the
    axes that split the other operand. (DTensor's own plan for this
    product computes every token's logits on every rank.)"""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    b, s, _ = x.shape
    xp = named_sharding(("batch", None, None), x.shape, mesh).placements
    tp = named_sharding(("vocab", None), table.shape, mesh).placements
    op = named_sharding(("batch", None, "vocab"), (b, s, table.shape[0]),
                        mesh).placements
    x_grad = tuple(Partial() if t.is_shard() else p for p, t in zip(xp, tp))
    t_grad = tuple(Partial() if p.is_shard() else t for p, t in zip(xp, tp))
    with outside_fake_mode():
        return local_map(
            lambda xl, tl: dot(xl, tl.to(xl.dtype), "bsd,vd->bsv"),
            out_placements=(op,), in_placements=(xp, tp),
            in_grad_placements=(x_grad, t_grad), device_mesh=mesh,
            redistribute_inputs=True)(x, table)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------
def mlp(params, x, reduce_dtype=None):
    dtype = x.dtype
    g = dot(x, params["w_gate"].to(dtype), "bsd,df->bsf")
    u = dot(x, params["w_up"].to(dtype), "bsd,df->bsf")
    h = (silu(g) * u).to(dtype)
    # row-parallel output: the product's dtype sets the width of the
    # tensor-parallel all-reduce
    y = dot(h, params["w_down"].to(dtype), "bsf,fd->bsd",
            out_dtype=reduce_dtype or F32)
    return reduced(y).to(dtype)


def reduced(y):
    """A row-parallel product's output, on DTensors summed over the mesh
    axes that split its contraction (a `Partial` placement) at the
    product's own dtype. DTensor carries `Partial` through a dtype cast,
    so without this the sum would cross the link after the cast to the
    model dtype; the identity on a plain tensor."""
    return constrain(y, ("batch",) + (None,) * (y.ndim - 1))


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def softmax_xent(logits, labels, mask=None, z_loss: float = 1e-4):
    """Cross entropy with optional z-loss; logits (B,S,V) taken in f32,
    labels (B,S) int; `mask` (B,S) weights the mean."""
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)
    # the gathered axis is dropped after the difference, not before: on a
    # vocab-sharded DTensor the gather is a masked partial sum that only
    # reduces at its own shape (the values are the same either way)
    loss = (lse[..., None] - gold)[..., 0]
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    if mask is None:
        return loss.mean()
    mask = mask.to(F32)
    return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
