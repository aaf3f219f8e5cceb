"""Model families of the port (the llama family so far)."""
from skypilot_tpu_torch.models.llama import Llama, LlamaConfig
from skypilot_tpu_torch.models.registry import get_model_config

__all__ = ['Llama', 'LlamaConfig', 'get_model_config']
