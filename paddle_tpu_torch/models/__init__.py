from .bert import (BERT_CONFIGS, BertConfig, bert_embed, bert_forward,
                   bert_init, bert_loss, bert_mlm_transform)
from .convert import opt_from_jax, params_from_jax, params_to_numpy
from .gpt import (GPT, GPT_CONFIGS, GPTConfig, gpt_block,
                  gpt_flops_per_token, gpt_forward, gpt_init, gpt_loss,
                  gpt_num_params, gpt_ragged_step)

__all__ = ["GPT", "GPTConfig", "GPT_CONFIGS", "gpt_init", "gpt_block",
           "gpt_forward", "gpt_loss", "gpt_ragged_step", "gpt_num_params",
           "gpt_flops_per_token", "BertConfig", "BERT_CONFIGS", "bert_init",
           "bert_embed", "bert_mlm_transform", "bert_forward", "bert_loss",
           "params_from_jax", "params_to_numpy", "opt_from_jax"]
