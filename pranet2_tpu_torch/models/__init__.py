# the model modules register their models
from pranet2_tpu_torch.models import emcad, merit, mist, pranet  # noqa: F401
from pranet2_tpu_torch.models.registry import (get_model, list_models,
                                               register_model)

__all__ = ["get_model", "list_models", "register_model"]
