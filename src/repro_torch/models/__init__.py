"""The attention-only decoder CREAM-Serve pages (port of the serving half of
:mod:`repro.models`)."""
from repro_torch.models.model import build_model, load_jax_params

__all__ = ["build_model", "load_jax_params"]
