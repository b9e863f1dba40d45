"""Architecture + shape configuration system.

Every assigned architecture is an ``ArchConfig`` (frozen dataclass). Shapes are
``ShapeConfig``s; the cross product (arch x shape) defines the dry-run matrix.
``ArchConfig.reduced()`` returns a tiny same-family config for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Block kinds used by hybrid / recurrent families.
ATTN = "attn"          # full (GQA) attention block
MLSTM = "mlstm"        # xLSTM matrix-memory block
SLSTM = "slstm"        # xLSTM scalar-memory block
MAMBA2 = "mamba2"      # Mamba2 / SSD block
SHARED_ATTN = "shared_attn"  # zamba2 shared transformer block marker


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four assigned LM shapes. decode_* / long_* lower `serve_step` (one new
# token against a KV cache of seq_len), NOT `train_step`.
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Smoke-test shapes (tiny, CPU-friendly).
SMOKE_SHAPES = {
    "smoke_train": ShapeConfig("smoke_train", 64, 2, "train"),
    "smoke_prefill": ShapeConfig("smoke_prefill", 64, 2, "prefill"),
    "smoke_decode": ShapeConfig("smoke_decode", 64, 2, "decode"),
}


# ArchConfig's options that the JAX package's has not, at the values that
# keep its block (Qwen3-MoE's routing, per-head q/k norms, eps 1e-6);
# OLMoE's published block is {False, "full", 1e-5}
PORT_OPTIONS = {"norm_topk_prob": True, "qk_norm_width": "head",
                "norm_eps": 1e-6}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | audio | ssm | hybrid | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                         # dense FFN width (expert width for MoE)
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qk_norm: bool = False
    # "head": q and k RMS-normalised per head with (head_dim,) scales;
    # "full": over the whole (num_heads * head_dim,) q and (num_kv_heads *
    # head_dim,) k projections before the split into heads (OLMoE)
    qk_norm_width: str = "head"
    rope_theta: float = 1e6
    # eps of the attention blocks' RMSNorms (norm1, norm2, the q/k norms)
    # and of the final norm; the SSM and xLSTM blocks keep their own
    norm_eps: float = 1e-6
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # True: the chosen experts weighted by the softmax over their k
    # logits; False: by the softmax over all experts, not renormalised
    norm_topk_prob: bool = True
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv_width: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    shared_attn_every: int = 0        # zamba2: run the shared attn block every N layers
    block_pattern: Tuple[str, ...] = ()  # per-layer block kinds; empty -> all ATTN
    # --- encoder/decoder (audio) ---
    encoder_layers: int = 0
    encoder_seq: int = 0              # stubbed frontend output length
    cross_attention: bool = False
    # --- frontends (stubs: input_specs() provides precomputed embeddings) ---
    frontend: str = ""                # "" | "audio_stub" | "vision_stub"
    frontend_tokens: int = 0          # e.g. ViT patch tokens prepended to text
    # --- attention policy ---
    window: int = 0                   # sliding-window size (0 = full attention)
    sub_quadratic: bool = False       # True iff long_500k is runnable
    # --- numerics ---
    dtype: str = "bfloat16"
    # --- training ---
    grad_accum_microbatches: int = 1

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def blocks(self) -> Tuple[str, ...]:
        """Per-layer block kinds for the decoder stack."""
        if self.block_pattern:
            assert len(self.block_pattern) == self.num_layers
            return self.block_pattern
        return (ATTN,) * self.num_layers

    # ---------------- parameter counting (for 6ND roofline) ----------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count of the decoder stack + embeddings."""
        d, hd = self.d_model, self.resolved_head_dim
        nh, nkv = self.num_heads, self.num_kv_heads
        counts = 0
        for kind in self.blocks():
            if kind == ATTN:
                counts += d * hd * (nh + 2 * nkv) + nh * hd * d  # qkv + o
                if self.qk_norm:
                    counts += (nh + nkv) * hd if self.qk_norm_width == \
                        "full" else 2 * hd
                counts += 2 * d  # 2 norms
                counts += self._ffn_params(active_only)
            elif kind == MAMBA2:
                counts += self._mamba2_params() + d
            elif kind == MLSTM:
                counts += self._mlstm_params() + d
            elif kind == SLSTM:
                counts += self._slstm_params() + d
        if self.shared_attn_every:
            n_shared = len(range(self.shared_attn_every - 1, self.num_layers,
                                 self.shared_attn_every))
            shared = (d * hd * (nh + 2 * nkv) + nh * hd * d + 2 * d
                      + 3 * d * self.d_ff)
            if active_only:
                counts += shared  # shared params counted once
            else:
                counts += shared  # they ARE shared; stored once
            del n_shared
        counts += self.vocab_size * d  # embedding
        counts += self.vocab_size * d  # unembedding (untied)
        counts += d                    # final norm
        if self.encoder_layers:
            enc_block = (d * hd * (nh + 2 * nkv) + nh * hd * d + 2 * d
                         + 2 * d * self.d_ff + d)
            counts += self.encoder_layers * enc_block
            # cross attention in each decoder layer
            counts += self.num_layers * (d * hd * (nh + 2 * nkv) + nh * hd * d + d)
        return counts

    def _ffn_params(self, active_only: bool) -> int:
        d = self.d_model
        if self.is_moe:
            e = self.experts_per_token if active_only else self.num_experts
            return e * 3 * d * self.d_ff + d * self.num_experts  # experts + router
        return 3 * d * self.d_ff  # SwiGLU: gate, up, down

    def _mamba2_params(self) -> int:
        d = self.d_model
        d_in = self.ssm_expand * d
        nheads = d_in // self.ssm_head_dim
        # in_proj -> [z, x, B, C, dt], conv over (x,B,C), out_proj
        d_bc = 2 * self.ssm_state
        return (d * (2 * d_in + d_bc + nheads)
                + self.ssm_conv_width * (d_in + d_bc)
                + 2 * nheads  # A_log, D
                + d_in  # norm before out proj
                + d_in * d)

    def _mlstm_params(self) -> int:
        d = self.d_model
        d_in = 2 * d  # up-projection factor 2
        return (2 * d * d_in          # up proj (x, gate paths)
                + 3 * d_in * d_in     # q, k, v
                + 2 * d_in            # i, f gate biases-ish (per-head proj approx)
                + 2 * d_in * 2        # igate/fgate projections (low rank approx)
                + d_in * d)           # down proj

    def _slstm_params(self) -> int:
        d = self.d_model
        # 4 gates x (recurrent + input) + ffn-ish projection factor 4/3*2
        dff = int(d * 8 / 3)
        return 8 * d * d + 2 * d * dff

    def model_flops_per_token(self, train: bool) -> float:
        """MODEL_FLOPS/token = 6N (train) or 2N (inference), active params."""
        n = self.param_count(active_only=True)
        return (6.0 if train else 2.0) * n

    # ---------------- reduced config for smoke tests ----------------
    def reduced(self) -> "ArchConfig":
        d = 64
        nh = 4
        nkv = max(1, min(self.num_kv_heads, 2))
        layers = min(self.num_layers, 4)
        kw = {}
        if self.block_pattern:
            pat = _reduce_pattern(self.block_pattern, layers)
            kw["block_pattern"] = pat
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=layers,
            d_model=d,
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=16,
            d_ff=128 if not self.is_moe else 32,
            vocab_size=256,
            num_experts=8 if self.is_moe else 0,
            experts_per_token=2 if self.is_moe else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            frontend_tokens=min(self.frontend_tokens, 8) if self.frontend_tokens else 0,
            window=min(self.window, 32) if self.window else 0,
            grad_accum_microbatches=1,
            # XLA:CPU's thunk runtime cannot execute some bf16 dots; smoke
            # tests run f32. Full configs stay bf16 (dry-run only lowers).
            dtype="float32",
            **kw,
        )

    def shape_supported(self, shape: ShapeConfig) -> Tuple[bool, str]:
        """(supported, reason). long_500k needs sub-quadratic attention."""
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False, ("pure full-attention arch: 512k-token decode requires "
                           "sub-quadratic attention (documented skip)")
        return True, ""


def _reduce_pattern(pattern: Tuple[str, ...], layers: int) -> Tuple[str, ...]:
    """Keep the block-kind diversity of the original pattern in `layers` slots."""
    kinds = []
    for k in pattern:
        if k not in kinds:
            kinds.append(k)
    out = [kinds[i % len(kinds)] for i in range(layers)]
    return tuple(out)
