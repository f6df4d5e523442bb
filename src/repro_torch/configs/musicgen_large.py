"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048. The EnCodec audio
frontend is a STUB per the assignment: input_specs() provides precomputed
frame-token ids in the 2048-code vocabulary; the backbone is a standard
decoder LM.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend="frame",
    mlp_variant="gelu",
)
