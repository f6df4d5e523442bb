"""Migration gather fused with SECDED re-encode."""
from repro_torch.kernels.migrate import ops, ref  # noqa: F401
