"""olmoe-1b-7b — 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (kv=16) per-expert d_ff=1024 vocab=50304,
MoE 64e top-8; QK-norm per the OLMoE recipe. ~7B total, ~1B active.
"""
from repro_torch.configs.base import BlockKind, MixerKind, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    qk_norm=True,
    pattern=((BlockKind.ATTN, MixerKind.MOE),),
    num_experts=64,
    experts_per_token=8,
    moe_d_ff=1024,
)
