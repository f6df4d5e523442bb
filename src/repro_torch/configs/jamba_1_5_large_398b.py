"""jamba-1.5-large-398b — Mamba+attention 1:7 interleave, MoE [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Period-8 super-block: 1 attention + 7 Mamba layers; MoE replaces the MLP on
every other layer (4 MoE / 4 dense-MLP per period). SSM state is O(1) ->
runs long_500k (the 9 attention layers use a sequence-sharded KV cache).
"""
from repro_torch.configs.base import BlockKind, MixerKind, ModelConfig

_PERIOD = (
    (BlockKind.ATTN, MixerKind.MOE),
    (BlockKind.MAMBA, MixerKind.MLP),
    (BlockKind.MAMBA, MixerKind.MOE),
    (BlockKind.MAMBA, MixerKind.MLP),
    (BlockKind.MAMBA, MixerKind.MOE),
    (BlockKind.MAMBA, MixerKind.MLP),
    (BlockKind.MAMBA, MixerKind.MOE),
    (BlockKind.MAMBA, MixerKind.MLP),
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    pattern=_PERIOD,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    ssm_state_dim=16,
    ssm_expand=2,
    subquadratic=True,
)
