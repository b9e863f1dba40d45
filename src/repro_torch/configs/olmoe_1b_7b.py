"""olmoe-1b-7b — MoE, 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) expert d_ff=1024 vocab=50304.

This entry is the JAX package's block at OLMoE's sizes: Qwen3-MoE's
(the chosen experts weighted by the softmax over their 8 logits, q and k
normalised per head, RMSNorm eps 1e-6), which the JAX parity tests hold
it to. OLMoE's published block is these sizes with three options of
``ArchConfig``: ``norm_topk_prob=False`` (the softmax over all 64
experts), ``qk_norm_width="full"`` (q and k normalised over their whole
2048-wide projections) and ``norm_eps=1e-5``, as the benchmark's
``portbench/configs/olmoe-1b-7b.json`` sets them in its
``port_overrides``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    qk_norm=True,
    rope_theta=1e4,
    grad_accum_microbatches=4,
)
