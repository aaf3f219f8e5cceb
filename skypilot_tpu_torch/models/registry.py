"""Named model configs of the port: the llama family of
``skypilot_tpu/models/registry.py`` (same names, same sizes).  The other
families are not ported yet and raise."""
from typing import Dict

from skypilot_tpu_torch.models.llama import LlamaConfig

_CONFIGS: Dict[str, LlamaConfig] = {}

# Families of the JAX registry that the port does not have yet.
_NOT_PORTED = ('gpt2', 'gpt2-medium', 'gpt2-large', 'gpt2-debug',
               'mixtral-8x7b', 'mixtral-debug', 'bert-base', 'bert-debug',
               'resnet50', 'resnet18-debug')


def _register(cfg: LlamaConfig) -> LlamaConfig:
    _CONFIGS[cfg.name] = cfg
    return cfg


# ----------------------------------------------------------------- llama
_register(
    LlamaConfig(name='llama2-7b', vocab_size=32000, hidden_size=4096,
                intermediate_size=11008, num_layers=32, num_heads=32,
                num_kv_heads=32, max_seq_len=4096))
_register(
    LlamaConfig(name='llama3-8b', vocab_size=128256, hidden_size=4096,
                intermediate_size=14336, num_layers=32, num_heads=32,
                num_kv_heads=8, max_seq_len=8192, rope_theta=500000.0))
_register(
    LlamaConfig(name='llama3.1-8b', vocab_size=128256, hidden_size=4096,
                intermediate_size=14336, num_layers=32, num_heads=32,
                num_kv_heads=8, max_seq_len=131072, rope_theta=500000.0,
                rope_scaling_factor=8.0, rope_scaling_low_freq=1.0,
                rope_scaling_high_freq=4.0,
                rope_scaling_original_max_len=8192))
_register(
    LlamaConfig(name='qwen2-7b', vocab_size=152064, hidden_size=3584,
                intermediate_size=18944, num_layers=28, num_heads=28,
                num_kv_heads=4, max_seq_len=32768, rope_theta=1e6,
                norm_eps=1e-6, attention_bias=True))
_register(
    LlamaConfig(name='mistral-7b', vocab_size=32000, hidden_size=4096,
                intermediate_size=14336, num_layers=32, num_heads=32,
                num_kv_heads=8, max_seq_len=32768, rope_theta=10000.0,
                sliding_window=4096))
# ~1.1B (TinyLlama-class): the entry-point forward and the serving model.
_register(
    LlamaConfig(name='llama-1b', vocab_size=32000, hidden_size=2048,
                intermediate_size=5632, num_layers=22, num_heads=16,
                num_kv_heads=8, max_seq_len=4096, tie_embeddings=True))
_register(
    LlamaConfig(name='llama-800m', vocab_size=32000, hidden_size=2048,
                intermediate_size=5632, num_layers=16, num_heads=16,
                num_kv_heads=8, max_seq_len=4096, tie_embeddings=True))
_register(
    LlamaConfig(name='llama-debug', vocab_size=256, hidden_size=64,
                intermediate_size=128, num_layers=2, num_heads=4,
                num_kv_heads=2, max_seq_len=256, tie_embeddings=True))

# ----------------------------------------------------------------- gemma
# head_dim 256: the Hopper attention kernels take it (64, 128 and 256),
# so gemma-7b and gemma-2b run their forward and training on the card;
# gemma-debug's head_dim 32 is still refused there (ROADMAP.md B2).
_register(
    LlamaConfig(name='gemma-7b', vocab_size=256000, hidden_size=3072,
                intermediate_size=24576, num_layers=28, num_heads=16,
                num_kv_heads=16, head_dim=256, max_seq_len=8192,
                tie_embeddings=True, hidden_act='gelu_tanh',
                scale_embeddings=True, hf_norm_zero_centered=True))
_register(
    LlamaConfig(name='gemma-2b', vocab_size=256000, hidden_size=2048,
                intermediate_size=16384, num_layers=18, num_heads=8,
                num_kv_heads=1, head_dim=256, max_seq_len=8192,
                tie_embeddings=True, hidden_act='gelu_tanh',
                scale_embeddings=True, hf_norm_zero_centered=True))
_register(
    LlamaConfig(name='gemma-debug', vocab_size=256, hidden_size=64,
                intermediate_size=128, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=32, max_seq_len=256,
                tie_embeddings=True, hidden_act='gelu_tanh',
                scale_embeddings=True, hf_norm_zero_centered=True))
_register(
    LlamaConfig(name='gemma-mqa-debug', vocab_size=256, hidden_size=64,
                intermediate_size=128, num_layers=2, num_heads=4,
                num_kv_heads=1, head_dim=32, max_seq_len=256,
                tie_embeddings=True, hidden_act='gelu_tanh',
                scale_embeddings=True, hf_norm_zero_centered=True))


def get_model_config(name: str) -> LlamaConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f'model {name!r} belongs to a family that is not yet ported '
            '(ROADMAP.md A8, other families and weight paths)')
    if name not in _CONFIGS:
        raise ValueError(
            f'Unknown model {name!r}. Available: {sorted(_CONFIGS)}')
    return _CONFIGS[name]
