"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517].

12L d_model=768 4H, d_ff=0 (block-internal up-projection), vocab=50304.
Pattern follows xLSTM[7:1]-ish placement: sLSTM at positions 3 and 9,
mLSTM elsewhere. Recurrent (O(1) state) -> sub-quadratic; long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, MLSTM, SLSTM

_PATTERN = tuple(SLSTM if i in (3, 9) else MLSTM for i in range(12))

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    block_pattern=_PATTERN,
    sub_quadratic=True,
)
