"""Model families of the port: llama (with gemma), GPT-2 and Mixtral."""
from skypilot_tpu_torch.models.gpt2 import GPT2, GPT2Config
from skypilot_tpu_torch.models.llama import Llama, LlamaConfig
from skypilot_tpu_torch.models.mixtral import Mixtral, MixtralConfig
from skypilot_tpu_torch.models.registry import (build_model,
                                                get_model_config,
                                                is_causal_lm, list_models)

__all__ = ['GPT2', 'GPT2Config', 'Llama', 'LlamaConfig', 'Mixtral',
           'MixtralConfig', 'build_model', 'get_model_config',
           'is_causal_lm', 'list_models']
