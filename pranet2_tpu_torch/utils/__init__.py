from pranet2_tpu_torch.utils.convert import (load_jax_variables,
                                            load_reference,
                                            load_reference_state_dict,
                                            state_dict_from_jax)

__all__ = ["load_jax_variables", "load_reference",
           "load_reference_state_dict", "state_dict_from_jax"]
