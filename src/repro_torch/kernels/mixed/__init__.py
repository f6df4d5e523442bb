"""Fused mixed-pool page read."""
from repro_torch.kernels.mixed.ops import read_correct  # noqa: F401
