"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304. xLSTM[7:1]: seven mLSTM
blocks per sLSTM block; no separate FFN (d_ff=0 — blocks carry their own
2x up-projection). Recurrent O(1) state -> runs long_500k.
"""
from repro_torch.configs.base import BlockKind, MixerKind, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=((BlockKind.MLSTM, MixerKind.NONE),) * 7
            + ((BlockKind.SLSTM, MixerKind.NONE),),
    subquadratic=True,
)
