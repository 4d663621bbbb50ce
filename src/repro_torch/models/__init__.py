from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import (build_model, count_active_params,
                                         count_params, param_shapes)

__all__ = ["ModelConfig", "build_model", "count_active_params", "count_params",
           "param_shapes"]
