"""Model assembly, decode path of the ATTN family (dense GQA stacks).

PyTorch counterpart of ``repro.models.model``: `init_model`,
`init_decode_state` and `decode_step` for configs whose every block is
an attention block with a dense SwiGLU MLP (qwen3, yi, minitron). The
reference's `lax.scan` over a run of stacked layers is a Python loop
over the run's (L,) axis. MoE, the recurrent and hybrid block kinds,
cross attention and `prefill` are not ported yet and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ATTN, ArchConfig
from repro_torch.models.attention import (decode_attention, init_attention,
                                          init_kv_cache)
from repro_torch.models.layers import (F32, embed, init_embedding, init_mlp,
                                       init_rms_norm, mlp, rms_norm, unembed)


@dataclass(frozen=True)
class ModelOptions:
    """Run-time (non-architectural) choices; of the reference's, the
    decode path reads only the sliding-window override."""
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
