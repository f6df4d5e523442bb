"""granite-34b — llama-arch code model, MQA [arXiv:2405.04324; hf].

88L d_model=6144 48H (GQA kv=1 — multi-query) d_ff=24576 vocab=49152.
The kv=1 cache is tiny; CREAM's capacity win for this arch concentrates in
the optimizer-state pool (DESIGN.md SS4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp_variant="gelu",
)
