"""internvl2-26b — VLM: InternViT frontend STUB + InternLM2-20B backbone
[arXiv:2404.16821; hf].

Backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553. The ViT is
stubbed: ``input_specs()`` provides precomputed patch embeddings of shape
(batch, frontend_tokens=256, d_model), prepended to the text sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    frontend="vision_stub",
    frontend_tokens=256,
    rope_theta=1e6,
    grad_accum_microbatches=8,
)
