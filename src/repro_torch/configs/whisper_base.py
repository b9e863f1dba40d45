"""whisper-base — audio enc-dec; conv frontend STUB [arXiv:2212.04356].

6L d_model=512 8H (MHA kv=8) d_ff=2048 vocab=51865. The conv1d/mel frontend is
stubbed: ``input_specs()`` provides precomputed frame embeddings of shape
(batch, encoder_seq=1500, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    encoder_layers=6,
    encoder_seq=1500,
    cross_attention=True,
    frontend="audio_stub",
    rope_theta=1e4,
    grad_accum_microbatches=4,
)
