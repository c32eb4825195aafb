from .convert import params_from_jax, params_to_numpy
from .gpt import GPT_CONFIGS, GPTConfig, gpt_init, gpt_ragged_step

__all__ = ["GPTConfig", "GPT_CONFIGS", "gpt_init", "gpt_ragged_step",
           "params_from_jax", "params_to_numpy"]
