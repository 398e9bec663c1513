from pranet2_tpu_torch.utils.convert import (load_jax_variables,
                                            state_dict_from_jax)

__all__ = ["load_jax_variables", "state_dict_from_jax"]
