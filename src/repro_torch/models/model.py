"""Model assembly of the ATTN family (dense GQA stacks): training
forward and loss, and the decode path.

PyTorch counterpart of ``repro.models.model``: `init_model`, `forward`,
`loss_fn`, `init_decode_state`, `decode_step` and `prefill` for configs
whose every block is an attention block with a dense SwiGLU MLP (qwen3,
yi, minitron). The reference's `lax.scan` over a run of stacked layers is
a Python loop over the run's (L,) axis; `jax.checkpoint` around the scan
body is `torch.utils.checkpoint` around each layer. MoE, the recurrent
and hybrid block kinds, cross attention, the frontends and zamba's shared
attention are not ported yet and raise.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ATTN, ArchConfig
from repro_torch.core.compute_plane import tree_leaves
from repro_torch.models.attention import (attention, decode_attention,
                                          init_attention, init_kv_cache)
from repro_torch.models.layers import (F32, apply_rope, dot, embed,
                                       init_embedding, init_mlp,
                                       init_rms_norm, mlp, rms_norm,
                                       softmax_xent, unembed)


@dataclass(frozen=True)
class ModelOptions:
    """Run-time (non-architectural) choices; of the reference's, the port
    reads the attention tiling, the rematerialisation policy and the
    sliding-window override."""
    triangular_flash: bool = True      # skip fully-masked causal KV blocks
    flash_threshold: int = 2048
    remat: str = "dots"                # "none" | "full" | "dots"
    window_override: Optional[int] = None  # force sliding window


def _window(cfg, opt):
    return opt.window_override if opt.window_override is not None \
        else cfg.window


def _plan(cfg: ArchConfig):
    """Decoder stack as runs of identical block kinds: [(kind, count)]."""
    runs = []
    for kind in cfg.blocks():
        if runs and runs[-1][0] == kind:
            runs[-1] = (kind, runs[-1][1] + 1)
        else:
            runs.append((kind, 1))
    return runs


def _check_ported(cfg: ArchConfig):
    if (cfg.is_moe or cfg.shared_attn_every or cfg.cross_attention
            or cfg.encoder_layers or cfg.frontend
            or any(kind != ATTN for kind in cfg.blocks())):
        raise NotImplementedError(
            f"{cfg.name}: only dense ATTN-family stacks are ported")


def init_model(cfg: ArchConfig, gen: torch.Generator, dtype=F32):
    """Random parameters in the reference's layout, drawn from `gen` on
    its device; `dtype` is the storage type of the weight matrices (the
    reference keeps f32 and casts at use, so bf16 storage computes the
    same bf16 decode)."""
    _check_ported(cfg)
    dev = gen.device
    params = {"embed": init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                      dtype)}
    runs = []
    for kind, count in _plan(cfg):
        runs.append({
            "norm1": init_rms_norm(cfg.d_model, layers=count, device=dev),
            "attn": init_attention(gen, cfg, layers=count, dtype=dtype),
            "norm2": init_rms_norm(cfg.d_model, layers=count, device=dev),
            "ffn": init_mlp(gen, cfg.d_model, cfg.d_ff, layers=count,
                            dtype=dtype),
        })
    params["runs"] = tuple(runs)
    params["final_norm"] = init_rms_norm(cfg.d_model, device=dev)
    params["unembed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                       dtype)
    return params


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      opt: ModelOptions, device=None):
    """Per-run stacked (L, B, T, K, H) KV caches, zeroed."""
    _check_ported(cfg)
    runs = []
    for _, count in _plan(cfg):
        one = init_kv_cache(cfg, batch, max_len, device=device)
        runs.append({k: v.expand((count,) + v.shape).contiguous()
                     for k, v in one.items()})
    return {"runs": tuple(runs)}


# ==========================================================================
# forward blocks (training)
# ==========================================================================
def _apply_block(kind, p, cfg, x, opt, *, causal=True, window=0, enc=None,
                 positions=None, collect_kv=False):
    """Returns (x, aux, kv_or_None): with `collect_kv`, the block's K and
    V for a decode cache, recomputed from the normed input (K through
    k_norm, then RoPE at `positions`), as the reference does."""
    if kind != ATTN:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    if enc is not None:
        raise NotImplementedError("cross attention is not ported")
    aux = torch.zeros((), dtype=F32, device=x.device)
    h = rms_norm(x, p["norm1"]["scale"])
    y = attention(p["attn"], cfg, h, positions=positions, causal=causal,
                  window=window, flash_threshold=opt.flash_threshold,
                  triangular=opt.triangular_flash)
    kv = None
    if collect_kv:
        dt = h.dtype
        k = dot(h, p["attn"]["wk"].to(dt), "btd,dkh->btkh").to(dt)
        if "k_norm" in p["attn"]:
            k = rms_norm(k, p["attn"]["k_norm"])
        k = apply_rope(k, positions if positions is not None
                       else torch.arange(h.shape[1], device=h.device),
                       cfg.rope_theta)
        v = dot(h, p["attn"]["wv"].to(dt), "btd,dkh->btkh").to(dt)
        kv = {"k": k.to(dt), "v": v.to(dt)}
    x = x + y
    h = rms_norm(x, p["norm2"]["scale"])
    return x + mlp(p["ffn"], h), aux, kv


_MATMULS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
            torch.ops.aten.baddbmm}


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat="dots": keep every matrix
    product's output, recompute the rest (the reference keeps the dots
    without batch dimensions; which products are kept changes memory and
    time, never values)."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op.overloadpacket in _MATMULS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, opt):
    """`fn` under the rematerialisation policy: "none" keeps every
    activation, "full" recomputes the layer in the backward pass, "dots"
    recomputes all but the matrix products."""
    if opt.remat == "none":
        return fn
    kw = {}
    if opt.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)
    elif opt.remat != "full":
        raise ValueError(f"remat must be none|full|dots, got {opt.remat!r}")
    return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False, **kw)


def _unstack(tree, count: int):
    """A stacked (L, ...) tree -> L per-layer trees of views. `unbind`
    gives the backward one stack of the L layer gradients per leaf, where
    indexing layer by layer would add L full-size zero-padded ones."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(count)]
    return list(torch.unbind(tree, 0))


def _run_scan(run_params, kind, x, cfg, opt, *, causal=True, window=0,
              enc=None, positions=None, collect_kv=False):
    """Run a stack of identical blocks with stacked (L, ...) params.
    Returns (x, aux, kvs): with `collect_kv`, kvs = {"k", "v"} stacked
    (L, B, S, K, H), else None."""
    count = tree_leaves(run_params)[0].shape[0]
    aux = torch.zeros((), dtype=F32, device=x.device)

    def body(xx, layer_p):
        return _apply_block(kind, layer_p, cfg, xx, opt, causal=causal,
                            window=window, enc=enc, positions=positions,
                            collect_kv=collect_kv)

    step = _remat(body, opt)
    kvs = []
    for layer_p in _unstack(run_params, count):
        x, a, kv = step(x, layer_p)
        aux = aux + a
        kvs.append(kv)
    if not collect_kv:
        return x, aux, None
    return x, aux, {k: torch.stack([kv[k] for kv in kvs]) for k in kvs[0]}


def forward(params, cfg: ArchConfig, batch, opt: ModelOptions):
    """Training forward. batch: {tokens (B,S) int} -> (logits (B,S,Vp)
    f32, aux)."""
    _check_ported(cfg)
    dtype = getattr(torch, cfg.dtype)
    x = embed(params["embed"], batch["tokens"].long(), dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    window = _window(cfg, opt)
    aux = torch.zeros((), dtype=F32, device=x.device)
    for (kind, _), run_params in zip(_plan(cfg), params["runs"]):
        x, a, _ = _run_scan(run_params, kind, x, cfg, opt, causal=True,
                            window=window, positions=positions)
        aux = aux + a
    x = rms_norm(x, params["final_norm"]["scale"])
    return unembed(params["unembed"], x), aux


def loss_fn(params, cfg: ArchConfig, batch, opt: ModelOptions):
    """(loss, {"xent", "aux"}): next-token cross entropy (+ z-loss) under
    the batch's mask, plus 0.01 * aux."""
    logits, aux = forward(params, cfg, batch, opt)
    labels = batch["labels"]
    mask = batch.get("mask")
    xent = softmax_xent(logits[:, :-1, :], labels[:, 1:],
                        None if mask is None else mask[:, 1:])
    loss = xent + 0.01 * aux
    return loss, {"xent": xent, "aux": aux}


def _layer(tree, i: int):
    """Layer i's view of a stacked (L, ...) parameter or state tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _decode_block(kind, p, cfg, x, state, pos, opt, window):
    if kind != ATTN:
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    h = rms_norm(x, p["norm1"]["scale"])
    y, _ = decode_attention(p["attn"], cfg, h, state, pos, window=window)
    x = x + y
    h = rms_norm(x, p["norm2"]["scale"])
    return x + mlp(p["ffn"], h), state


def decode_step(params, cfg: ArchConfig, state, tokens, pos: int,
                opt: ModelOptions):
    """One decode step. tokens: (B,1) int; pos: the Python int position.
    The KV caches in `state` are written in place.

    Returns (logits (B, vocab_padded) f32, state)."""
    dtype = getattr(torch, cfg.dtype)
    x = embed(params["embed"], tokens, dtype)
    window = _window(cfg, opt)
    for (kind, count), run_params, run_state in zip(
            _plan(cfg), params["runs"], state["runs"]):
        for i in range(count):
            x, _ = _decode_block(kind, _layer(run_params, i), cfg, x,
                                 _layer(run_state, i), pos, opt, window)
    x = rms_norm(x, params["final_norm"]["scale"])
    logits = unembed(params["unembed"], x)[:, 0, :]
    return logits, state


def prefill(params, cfg: ArchConfig, batch, max_len: int,
            opt: ModelOptions):
    """One-pass prefill: the forward over `batch["tokens"]` (B, S) and a
    decode-ready state whose KV caches (max_len positions) hold the
    prompt's K and V from row 0. Returns (logits (B, S, vocab_padded)
    f32, state)."""
    _check_ported(cfg)
    dtype = getattr(torch, cfg.dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed(params["embed"], tokens.long(), dtype)
    positions = torch.arange(s, device=x.device)
    window = _window(cfg, opt)
    state = init_decode_state(cfg, b, max_len, opt, device=x.device)
    for (kind, _), run_params, run_state in zip(
            _plan(cfg), params["runs"], state["runs"]):
        x, _, kv = _run_scan(run_params, kind, x, cfg, opt, causal=True,
                             window=window, positions=positions,
                             collect_kv=True)
        run_state["k"][:, :, :s] = kv["k"]
        run_state["v"][:, :, :s] = kv["v"]
    x = rms_norm(x, params["final_norm"]["scale"])
    return unembed(params["unembed"], x), state
