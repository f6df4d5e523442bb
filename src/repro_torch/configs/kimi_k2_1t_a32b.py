"""kimi-k2-1t-a32b — trillion-param MoE (paper-table) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) per-expert d_ff=2048 vocab=163840,
MoE 384 experts top-8. Every layer: attention + MoE mixer. head_dim=112
(7168/64). ~1T total parameters, ~32B active per token.
"""
from repro_torch.configs.base import BlockKind, MixerKind, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    pattern=((BlockKind.ATTN, MixerKind.MOE),),
    num_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
)
