"""The attention-only decoder CREAM-Serve pages and the training path
trains (port of :mod:`repro.models` for those families)."""
from repro_torch.models.model import (build_model, count_params,
                                      load_jax_params, params_tree)

__all__ = ["build_model", "count_params", "load_jax_params", "params_tree"]
