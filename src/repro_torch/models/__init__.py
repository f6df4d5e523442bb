"""The model families (attention, Mamba, mLSTM and sLSTM blocks with
MLP, MoE or no mixers): port of :mod:`repro.models`."""
from repro_torch.models.model import (build_model, count_params,
                                      load_jax_params, model_flops_per_token,
                                      params_tree)

__all__ = ["build_model", "count_params", "load_jax_params",
           "model_flops_per_token", "params_tree"]
