"""zamba2-2.7b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242; hf].

54 Mamba2 layers, d_model=2560, ssm_state=64; a single SHARED transformer block
(32H MHA kv=32, d_ff=10240) is invoked every 6 layers with tied parameters.
Sub-quadratic (SSM backbone + windowed shared attention at long context);
long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, MAMBA2

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
    block_pattern=(MAMBA2,) * 54,
    window=4096,          # shared-attn block uses sliding window at long context
    sub_quadratic=True,
    grad_accum_microbatches=4,
)
