"""Model assembly: family-dispatched decoder stacks — training forward
and loss, and the decode path.

PyTorch counterpart of ``repro.models.model``: `init_model`, `forward`,
`loss_fn`, `init_decode_state`, `decode_step` and `prefill` for every
family of the reference:

- dense (GQA attention + SwiGLU MLP: qwen3, yi, minitron) and MoE (the
  MLP swapped for the routed experts: olmoe, qwen3-moe);
- vlm (internvl2): the dense stack with the `vision_stub` frontend's
  patch embeddings prepended to the text;
- audio (whisper): an encoder of non-causal ATTN blocks over the
  `audio_stub` frame embeddings, and decoder blocks that add cross
  attention over its output. As in the reference, the decode state's
  cross cache (`xk`/`xv`) is zeros that neither `prefill` nor the decode
  ever writes, so a decode attends uniformly over zero values;
- ssm (xlstm): runs of mLSTM and sLSTM blocks;
- hybrid (zamba2): Mamba2 layers with one shared attention block applied
  every `shared_attn_every` layers, tied weights, its input re-injected
  with the embedding.

The reference's `lax.scan` over a run of stacked layers is a Python loop
over the run's (L,) axis; `jax.checkpoint` around the scan body is
`torch.utils.checkpoint` around each layer.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ATTN, MAMBA2, MLSTM, SLSTM, ArchConfig
from repro_torch.core import telemetry
from repro_torch.core.compute_plane import tree_leaves, tree_map
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import (attention, attention_axes,
                                          decode_attention,
                                          decode_cross_attention,
                                          init_attention, init_kv_cache,
                                          kv_cache_axes, qk_norm)
from repro_torch.models.layers import (F32, apply_rope, dot, dot_counts,
                                       embed, embedding_axes, init_embedding,
                                       init_mlp, init_rms_norm, mlp,
                                       mlp_axes, rms_norm, rms_norm_axes,
                                       softmax_xent, stacked_axes, unembed)
from repro_torch.runtime.mesh_rules import constrain, is_dtensor, place


@dataclass(frozen=True)
class ModelOptions:
    """Run-time (non-architectural) choices, the reference's: the MoE
    path, the attention tiling, the rematerialisation policy, the KV
    cache's sequence axis for the mesh rules, the SSD chunk, the
    sliding-window override, the two tensor-parallel knobs
    (`tp_reduce_bf16`, `seq_shard_residual`, which change what crosses
    the link only on DTensors) and the ring KV cache."""
    moe_impl: str = "dense"            # "dense" | "ep" (needs a mesh)
    triangular_flash: bool = True      # skip fully-masked causal KV blocks
    flash_threshold: int = 2048
    remat: str = "dots"                # "none" | "full" | "dots"
    # the decode cache's sequence axis: "kv_seq" | "long_seq" (names it
    # in `decode_state_axes` only)
    kv_seq_axis: str = "kv_seq"
    ssd_chunk: int = 256
    window_override: Optional[int] = None  # force sliding window
    # row-parallel matmul outputs (attention wo, MLP w_down) accumulate
    # in bf16 so the tensor-parallel all-reduce crosses the link at half
    # width (f32 -> bf16)
    tp_reduce_bf16: bool = False
    # Megatron-SP: shard the residual stream's seq dim over the model
    # axis at the end of every block ("seq_sp")
    seq_shard_residual: bool = False
    # windowed archs keep only the last `window` tokens of KV (cache rows
    # = window, writes at pos % window)
    window_ring: bool = False


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


# ==========================================================================
# init
# ==========================================================================
_MIXERS = {MAMBA2: ssm_mod.init_mamba2, MLSTM: xlstm_mod.init_mlstm,
           SLSTM: xlstm_mod.init_slstm}


def _init_block(gen, cfg, kind, count: int, dtype, cross: bool = False):
    """Parameters of `count` stacked blocks of `kind` (count 0: one
    unstacked block); `cross` adds an ATTN block's cross attention."""
    def norm():
        return init_rms_norm(cfg.d_model, layers=count, device=gen.device)

    if kind in _MIXERS:
        return {"norm1": norm(),
                "mixer": _MIXERS[kind](gen, cfg, layers=count, dtype=dtype)}
    if kind != ATTN:
        raise ValueError(kind)
    p = {"norm1": norm(),
         "attn": init_attention(gen, cfg, layers=count, dtype=dtype)}
    if cross:
        p["norm_x"] = norm()
        p["xattn"] = init_attention(gen, cfg, cross=True, layers=count,
                                    dtype=dtype)
    p["norm2"] = norm()
    if cfg.is_moe:
        p["ffn"] = moe_mod.init_moe(gen, cfg, layers=count, dtype=dtype)
    else:
        p["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, layers=count,
                            dtype=dtype)
    return p


def init_model(cfg: ArchConfig, gen: torch.Generator, dtype=F32):
    """Random parameters in the reference's layout, drawn from `gen` on
    its device; `dtype` is the storage type of the weight matrices (the
    reference keeps f32 and casts at use, so bf16 storage computes the
    same bf16 decode)."""
    dev = gen.device
    params = {"embed": init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                      dtype)}
    params["runs"] = tuple(
        _init_block(gen, cfg, kind, count, dtype, cfg.cross_attention)
        for kind, count in _plan(cfg))
    if cfg.shared_attn_every:
        params["shared_attn"] = _init_block(gen, cfg, ATTN, 0, dtype)
    if cfg.encoder_layers:
        params["encoder"] = {
            "runs": _init_block(gen, cfg, ATTN, cfg.encoder_layers, dtype),
            "norm": init_rms_norm(cfg.d_model, device=dev)}
    params["final_norm"] = init_rms_norm(cfg.d_model, device=dev)
    params["unembed"] = init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                       dtype)
    return params


_MIXER_AXES = {MAMBA2: ssm_mod.mamba2_axes, MLSTM: xlstm_mod.mlstm_axes,
               SLSTM: xlstm_mod.slstm_axes}


def _block_axes(cfg, kind, cross: bool = False):
    """Logical axes of one block of `kind`, laid out as `_init_block`'s
    parameters."""
    if kind in _MIXER_AXES:
        return {"norm1": rms_norm_axes(), "mixer": _MIXER_AXES[kind]()}
    if kind != ATTN:
        raise ValueError(kind)
    a = {"norm1": rms_norm_axes(), "attn": attention_axes(cfg)}
    if cross:
        a["norm_x"] = rms_norm_axes()
        a["xattn"] = attention_axes(cfg, cross=True)
    a["norm2"] = rms_norm_axes()
    a["ffn"] = moe_mod.moe_axes() if cfg.is_moe else mlp_axes()
    return a


def param_axes(cfg: ArchConfig):
    """The logical axes of `init_model(cfg, ...)`'s tree: the same
    structure, each leaf a tuple of axis names (a stacked run's leaves
    lead with "layers") — the reference's axes for the leaf that
    ``convert.params_from_numpy`` maps onto it."""
    axes = {"embed": embedding_axes(),
            "runs": tuple(stacked_axes(_block_axes(cfg, kind,
                                                   cfg.cross_attention))
                          for kind, _ in _plan(cfg))}
    if cfg.shared_attn_every:
        axes["shared_attn"] = _block_axes(cfg, ATTN)
    if cfg.encoder_layers:
        axes["encoder"] = {"runs": stacked_axes(_block_axes(cfg, ATTN)),
                           "norm": rms_norm_axes()}
    axes["final_norm"] = rms_norm_axes()
    axes["unembed"] = embedding_axes()
    return axes


# ==========================================================================
# forward blocks (training / prefill)
# ==========================================================================
def _apply_block(kind, p, cfg, x, opt, *, causal=True, window=0, enc=None,
                 positions=None, collect_kv=False):
    """Returns (x, aux, kv_or_None): with `collect_kv`, an ATTN block's K
    and V for a decode cache, recomputed from the normed input (K through
    k_norm, then RoPE at `positions`), as the reference does. With `enc`
    (B,T,D), an ATTN block adds cross attention over it after the self
    attention."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    if kind == MAMBA2:
        h = rms_norm(x, p["norm1"]["scale"])
        return _residual(x + ssm_mod.mamba2(p["mixer"], cfg, h,
                                            chunk=opt.ssd_chunk),
                         opt), aux, None
    if kind in (MLSTM, SLSTM):
        fwd = xlstm_mod.mlstm if kind == MLSTM else xlstm_mod.slstm
        h = rms_norm(x, p["norm1"]["scale"])
        return _residual(x + fwd(p["mixer"], cfg, h), opt), aux, None
    if kind != ATTN:
        raise ValueError(kind)
    rdt = torch.bfloat16 if opt.tp_reduce_bf16 else None
    eps = cfg.norm_eps
    h = rms_norm(x, p["norm1"]["scale"], eps)
    y = attention(p["attn"], cfg, h, positions=positions, causal=causal,
                  window=window, flash_threshold=opt.flash_threshold,
                  triangular=opt.triangular_flash, reduce_dtype=rdt)
    kv = None
    if collect_kv:
        dt = h.dtype
        k = dot(h, p["attn"]["wk"].to(dt), "btd,dkh->btkh").to(dt)
        if "k_norm" in p["attn"]:
            k = qk_norm(k, p["attn"]["k_norm"], cfg)
        k = apply_rope(k, positions if positions is not None
                       else torch.arange(h.shape[1], device=h.device),
                       cfg.rope_theta)
        v = dot(h, p["attn"]["wv"].to(dt), "btd,dkh->btkh").to(dt)
        kv = {"k": k.to(dt), "v": v.to(dt)}
    x = x + y
    if enc is not None:
        h = rms_norm(x, p["norm_x"]["scale"], eps)
        x = x + attention(p["xattn"], cfg, h, kv_x=enc, causal=False,
                          flash_threshold=opt.flash_threshold)
    h = rms_norm(x, p["norm2"]["scale"], eps)
    if cfg.is_moe:
        y, aux = moe_mod.moe(p["ffn"], cfg, h, impl=opt.moe_impl)
    else:
        y = mlp(p["ffn"], h, reduce_dtype=rdt)
    return _residual(x + y, opt), aux, kv


def _residual(x, opt=None):
    """The residual stream's constraint: split over the batch, and at the
    end of a block with `opt.seq_shard_residual` over "seq_sp" too."""
    seq = "seq_sp" if opt is not None and opt.seq_shard_residual else None
    return constrain(x, ("batch", seq, None))


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


def _zamba_groups(params, cfg):
    """View the stacked (L, ...) mamba params as (groups, per, ...)."""
    per = cfg.shared_attn_every
    groups = cfg.num_layers // per
    return tree_map(lambda t: t.reshape((groups, per) + t.shape[1:]),
                    params), groups, per


def _forward_stack(params, cfg, x, opt, *, positions=None, enc=None,
                   collect_kv=False):
    """Run the decoder stack (with cross attention over `enc` when it is
    given). Returns (x, aux, caches: one per run of the plan, each None
    or {"k", "v"} stacked over the run's layers). The hybrid collects no
    caches: its prefill leaves the state zero, as the reference's
    does."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    window = _window(cfg, opt)
    if cfg.shared_attn_every:
        # zamba2: groups of `per` mamba layers + the tied shared block,
        # whose input re-injects the embedding output
        gp, groups, per = _zamba_groups(params["runs"][0], cfg)
        x0 = x

        def shared_block(sa_in, shared_p):
            return _apply_block(ATTN, shared_p, cfg, sa_in, opt,
                                causal=True, window=window,
                                positions=positions)

        shared_fn = _remat(shared_block, opt)
        for g_params in _unstack(gp, groups):
            x, a, _ = _run_scan(g_params, MAMBA2, x, cfg, opt,
                                positions=positions)
            x, a2, _ = shared_fn(x + x0, params["shared_attn"])
            aux = aux + a + a2
        return x, aux, [None]
    caches = []
    for (kind, _), run_params in zip(_plan(cfg), params["runs"]):
        x, a, kvs = _run_scan(run_params, kind, x, cfg, opt, causal=True,
                              window=window, enc=enc, positions=positions,
                              collect_kv=collect_kv and kind == ATTN)
        aux = aux + a
        caches.append(kvs)
    return x, aux, caches


def _encode(params, cfg, frontend, opt):
    """Whisper-style encoder over the stubbed frame embeddings (B, T, D):
    non-causal ATTN blocks, then the encoder's norm."""
    x = frontend.to(getattr(torch, cfg.dtype))
    x, _, _ = _run_scan(params["encoder"]["runs"], ATTN, x, cfg, opt,
                        causal=False)
    return rms_norm(x, params["encoder"]["norm"]["scale"], cfg.norm_eps)


def _embed_inputs(params, cfg, batch, opt):
    """The decoder's input (B, T, D) and the encoder output or None:
    `vision_stub` prepends the batch's frontend embeddings (B, F, D) to
    the token embeddings, `audio_stub` encodes its frames."""
    dtype = getattr(torch, cfg.dtype)
    x = embed(params["embed"], batch["tokens"].long(), dtype)
    enc = None
    if cfg.frontend == "vision_stub":
        x = torch.cat([batch["frontend"].to(dtype), x], dim=1)
    elif cfg.frontend == "audio_stub":
        enc = _encode(params, cfg, batch["frontend"], opt)
    return _residual(x), enc


def forward(params, cfg: ArchConfig, batch, opt: ModelOptions):
    """Training forward. batch: {tokens (B,S) int, frontend (the stubs'
    embeddings)} -> (logits (B,T,Vp) f32, aux); T = S, or F + S with
    `vision_stub`."""
    x, enc = _embed_inputs(params, cfg, batch, opt)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux, _ = _forward_stack(params, cfg, x, opt, positions=positions,
                               enc=enc)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["unembed"], x), aux


def loss_fn(params, cfg: ArchConfig, batch, opt: ModelOptions):
    """(loss, {"xent", "aux"}): next-token cross entropy (+ z-loss) under
    the batch's mask over the text positions, plus 0.01 * aux."""
    logits, aux = forward(params, cfg, batch, opt)
    if cfg.frontend == "vision_stub":
        logits = logits[:, cfg.frontend_tokens:, :]
    labels = batch["labels"]
    mask = batch.get("mask")
    xent = softmax_xent(logits[:, :-1, :], labels[:, 1:],
                        None if mask is None else mask[:, 1:])
    loss = xent + 0.01 * aux
    return loss, {"xent": xent, "aux": aux}


# ==========================================================================
# decode state + step
# ==========================================================================
def _kv_rows(cfg, opt, max_len: int) -> int:
    """Cache rows of an attention layer: `max_len`, or at most the window
    with the ring cache."""
    window = _window(cfg, opt)
    return min(max_len, window) if opt.window_ring and window else max_len


def _stacked_kv(cfg, batch: int, rows: int, count: int, device,
                cross: bool = False):
    """KV caches of `count` ATTN layers, (count, B, rows, K, H); `cross`
    adds the zero cross cache xk/xv (count, B, encoder_seq, K, H)."""
    one = init_kv_cache(cfg, batch, rows, device=device)
    if cross:
        enc = init_kv_cache(cfg, batch, cfg.encoder_seq, device=device)
        one.update(xk=enc["k"], xv=enc["v"])
    return {k: v.expand((count,) + v.shape).contiguous()
            for k, v in one.items()}


_STATES = {MAMBA2: ssm_mod.init_mamba2_state,
           MLSTM: xlstm_mod.init_mlstm_state,
           SLSTM: xlstm_mod.init_slstm_state}


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      opt: ModelOptions, device=None):
    """Zeroed decode state {"runs": (...)}: per run of the plan, the
    stacked (L, B, T, K, H) KV caches of an ATTN run (with whisper's
    cross cache xk/xv) or the (L, ...) recurrent states of a MAMBA2,
    MLSTM or SLSTM run. The hybrid has two entries: the mamba states as
    (groups, per, B, ...) and the shared block's KV caches as (groups,
    B, T, K, H)."""
    rows = _kv_rows(cfg, opt, max_len)
    if cfg.shared_attn_every:
        groups = cfg.num_layers // cfg.shared_attn_every
        mamba = ssm_mod.init_mamba2_state(
            cfg, batch, layers=(groups, cfg.shared_attn_every),
            device=device)
        return {"runs": (mamba, _stacked_kv(cfg, batch, rows, groups,
                                            device))}
    runs = []
    for kind, count in _plan(cfg):
        if kind == ATTN:
            runs.append(_stacked_kv(cfg, batch, rows, count, device,
                                    cfg.cross_attention))
        elif kind in _STATES:
            runs.append(_STATES[kind](cfg, batch, layers=(count,),
                                      device=device))
        else:
            raise ValueError(kind)
    return {"runs": tuple(runs)}


_STATE_AXES = {MAMBA2: ssm_mod.mamba2_state_axes,
               MLSTM: xlstm_mod.mlstm_state_axes,
               SLSTM: xlstm_mod.slstm_state_axes}


def decode_state_axes(cfg: ArchConfig, batch: int, max_len: int,
                      opt: ModelOptions):
    """The logical axes of `init_decode_state(cfg, batch, max_len, opt)`'s
    tree; the KV caches' sequence axis is `opt.kv_seq_axis`, whisper's
    cross cache is ("batch", None, "tensor_kv", None), and the hybrid's
    mamba states lead with two "layers" axes (groups, per)."""
    del batch, max_len                   # the axes do not depend on them
    kv = kv_cache_axes(opt.kv_seq_axis)
    if cfg.shared_attn_every:
        return {"runs": (stacked_axes(ssm_mod.mamba2_state_axes(), 2),
                         stacked_axes(kv))}
    runs = []
    for kind, _ in _plan(cfg):
        if kind == ATTN:
            a = dict(kv)
            if cfg.cross_attention:
                a["xk"] = a["xv"] = ("batch", None, "tensor_kv", None)
        elif kind in _STATE_AXES:
            a = _STATE_AXES[kind]()
        else:
            raise ValueError(kind)
        runs.append(stacked_axes(a))
    return {"runs": tuple(runs)}


def _layer(tree, *i):
    """The view at index `i` of the leading axes of a stacked parameter
    or state tree."""
    return tree_map(lambda t: t[i], tree)


_DECODERS = {MAMBA2: ssm_mod.mamba2_decode, MLSTM: xlstm_mod.mlstm_decode,
             SLSTM: xlstm_mod.slstm_decode}


def _decode_block(kind, p, cfg, x, state, pos, opt, window):
    """One block on one new token; `state` (the layer's KV cache or
    recurrent state) is written in place. Returns (x, state)."""
    if kind in _DECODERS:
        h = rms_norm(x, p["norm1"]["scale"])
        y, state = _DECODERS[kind](p["mixer"], cfg, h, state)
        return x + y, state
    if kind != ATTN:
        raise ValueError(kind)
    eps = cfg.norm_eps
    h = rms_norm(x, p["norm1"]["scale"], eps)
    y, _ = decode_attention(p["attn"], cfg, h, state, pos, window=window,
                            ring=opt.window_ring and window > 0)
    x = x + y
    if "xk" in state:
        h = rms_norm(x, p["norm_x"]["scale"], eps)
        x = x + decode_cross_attention(p["xattn"], cfg, h,
                                       {"k": state["xk"], "v": state["xv"]})
    h = rms_norm(x, p["norm2"]["scale"], eps)
    if cfg.is_moe:
        y, _ = moe_mod.moe(p["ffn"], cfg, h, impl=opt.moe_impl)
    else:
        y = mlp(p["ffn"], h)
    return x + y, state


def decode_step(params, cfg: ArchConfig, state, tokens, pos: int,
                opt: ModelOptions):
    """One decode step. tokens: (B,1) int; pos: the Python int position.
    The KV caches and recurrent states in `state` are written in place.
    Its layer span (``telemetry.span``) is `model.decode`.

    The span notes `dot_kernel` and `dot_widened`, the step's weight
    products that went through the decode matmul kernel and that widened
    on the card (`layers.dot_counts`).

    Returns (logits (B, vocab_padded) f32, state)."""
    with telemetry.span("model.decode", batch=tokens.shape[0]):
        kernel0, widened0 = dot_counts.kernel, dot_counts.widened
        dtype = getattr(torch, cfg.dtype)
        x = _residual(embed(params["embed"], tokens, dtype))
        window = _window(cfg, opt)
        if cfg.shared_attn_every:
            gp, groups, per = _zamba_groups(params["runs"][0], cfg)
            m_state, sa_state = state["runs"]
            x0 = x
            for g in range(groups):
                for i in range(per):
                    x, _ = _decode_block(MAMBA2, _layer(gp, g, i), cfg, x,
                                         _layer(m_state, g, i), pos, opt,
                                         window)
                x, _ = _decode_block(ATTN, params["shared_attn"], cfg,
                                     x + x0, _layer(sa_state, g), pos, opt,
                                     window)
        else:
            for (kind, count), run_params, run_state in zip(
                    _plan(cfg), params["runs"], state["runs"]):
                for i in range(count):
                    x, _ = _decode_block(kind, _layer(run_params, i), cfg, x,
                                         _layer(run_state, i), pos, opt,
                                         window)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        logits = unembed(params["unembed"], x)[:, 0, :]
        telemetry.note("model.decode",
                       dot_kernel=dot_counts.kernel - kernel0,
                       dot_widened=dot_counts.widened - widened0)
    return logits, state


def prefill(params, cfg: ArchConfig, batch, max_len: int,
            opt: ModelOptions):
    """One-pass prefill: the forward over `batch["tokens"]` (B, S) (and
    the frontend input, as in `forward`) and a decode-ready state whose
    ATTN KV caches (max_len positions) hold the T = S (F + S with
    `vision_stub`) input positions' K and V from row 0. As in the
    reference, the recurrent states (the hybrid's, with its shared
    block's caches, and xLSTM's) and whisper's cross cache stay zero: the
    serve loops prefill token by token through `decode_step`. Returns
    (logits (B, T, vocab_padded) f32, state)."""
    x, enc = _embed_inputs(params, cfg, batch, opt)
    b, t = x.shape[:2]
    positions = torch.arange(t, device=x.device)
    x, _, caches = _forward_stack(params, cfg, x, opt, positions=positions,
                                  enc=enc, collect_kv=True)
    state = init_decode_state(cfg, b, max_len, opt, device=x.device)
    if is_dtensor(x):
        # a sharded step: the new state is placed by the mesh rules, the
        # counterpart of the reference's sharding of its output
        state = place(state, decode_state_axes(cfg, b, max_len, opt),
                      x.device_mesh)
    for run_state, kv in zip(state["runs"], caches):
        if kv is None:
            continue
        if t > run_state["k"].shape[2]:
            raise ValueError(
                f"prefill of {t} positions (frontend tokens included) does "
                f"not fit a KV cache of {run_state['k'].shape[2]} rows: "
                f"raise max_len")
        run_state["k"][:, :, :t] = kv["k"]
        run_state["v"][:, :, :t] = kv["v"]
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params["unembed"], x), state
