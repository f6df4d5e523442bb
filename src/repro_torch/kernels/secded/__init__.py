"""SECDED(72,64) encode / decode-correct kernels."""
