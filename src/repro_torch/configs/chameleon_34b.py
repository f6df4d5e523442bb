"""chameleon-34b — early-fusion VLM over VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (text + VQ image
codes in one vocabulary). QK-norm per the paper's stability recipe. The
image tokenizer frontend is a STUB per the assignment: input_specs() feeds
precomputed token ids (early fusion makes the backbone token-uniform).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    frontend="patch",
)
