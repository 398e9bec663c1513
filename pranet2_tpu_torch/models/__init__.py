from pranet2_tpu_torch.models import pranet  # noqa: F401  (registers models)
from pranet2_tpu_torch.models.registry import (get_model, list_models,
                                               register_model)

__all__ = ["get_model", "list_models", "register_model"]
