"""SECDED decode-on-load matrix product of protected bf16 weights."""
