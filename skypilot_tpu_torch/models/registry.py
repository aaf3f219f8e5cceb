"""Named model configs of the port: every family of
``skypilot_tpu/models/registry.py`` (llama, gemma, GPT-2, Mixtral, BERT,
ResNet; same names, same sizes) and ``build_model``/``is_causal_lm``,
which pick a config's module."""
import dataclasses
from typing import Any, Dict, Union

from torch import nn

from skypilot_tpu_torch.models.bert import (Bert, BertConfig,
                                            BertForMaskedLM,
                                            BertForSequenceClassification)
from skypilot_tpu_torch.models.gpt2 import GPT2, GPT2Config, GPT2RankConfig
from skypilot_tpu_torch.models.llama import Llama, LlamaConfig, RankConfig
from skypilot_tpu_torch.models.mixtral import (Mixtral, MixtralConfig,
                                               MixtralRankConfig)
from skypilot_tpu_torch.models.resnet import ResNet, ResNetConfig

CausalLMConfig = Union[LlamaConfig, GPT2Config, MixtralConfig]
ModelConfig = Union[CausalLMConfig, BertConfig, ResNetConfig]

_CONFIGS: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
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


# ------------------------------------------------------------------ gpt2
_register(GPT2Config(name='gpt2', vocab_size=50257, hidden_size=768,
                     num_layers=12, num_heads=12, max_seq_len=1024))
_register(GPT2Config(name='gpt2-medium', vocab_size=50257,
                     hidden_size=1024, num_layers=24, num_heads=16,
                     max_seq_len=1024))
_register(GPT2Config(name='gpt2-large', vocab_size=50257,
                     hidden_size=1280, num_layers=36, num_heads=20,
                     max_seq_len=1024))
_register(GPT2Config(name='gpt2-debug', vocab_size=256, hidden_size=64,
                     num_layers=2, num_heads=4, max_seq_len=128))

# --------------------------------------------------------------- mixtral
_register(
    MixtralConfig(name='mixtral-8x7b', vocab_size=32000, hidden_size=4096,
                  intermediate_size=14336, num_layers=32, num_heads=32,
                  num_kv_heads=8, num_experts=8, experts_per_token=2,
                  max_seq_len=4096))
_register(
    MixtralConfig(name='mixtral-debug', vocab_size=256, hidden_size=64,
                  intermediate_size=128, num_layers=2, num_heads=4,
                  num_kv_heads=2, num_experts=4, experts_per_token=2,
                  max_seq_len=128, tie_embeddings=True))

# ------------------------------------------------------------------ bert
_register(BertConfig(name='bert-base', vocab_size=30522, hidden_size=768,
                     num_layers=12, num_heads=12, intermediate_size=3072,
                     max_seq_len=512))
_register(BertConfig(name='bert-debug', vocab_size=256, hidden_size=64,
                     num_layers=2, num_heads=4, intermediate_size=128,
                     max_seq_len=128))

# ---------------------------------------------------------------- resnet
_register(ResNetConfig(name='resnet50', stage_sizes=(3, 4, 6, 3)))
_register(ResNetConfig(name='resnet18-debug', stage_sizes=(1, 1),
                       width=8, num_classes=10))


def get_model_config(name: str) -> ModelConfig:
    if name not in _CONFIGS:
        raise ValueError(
            f'Unknown model {name!r}. Available: {sorted(_CONFIGS)}')
    return _CONFIGS[name]


def build_model(config: Any, head: str = 'lm', device=None,
                param_dtype=None) -> nn.Module:
    """Config -> the port's module on `device` (``param_dtype`` as each
    module takes it).  `head` picks the task head of the encoder family
    ('lm' | 'mlm' | 'classify'), as the JAX ``build_model`` does; the
    other families ignore it."""
    if isinstance(config, BertConfig):
        module = {'classify': BertForSequenceClassification,
                  'mlm': BertForMaskedLM}.get(head, Bert)
        return module(config, device=device, param_dtype=param_dtype)
    for cfg_type, module in ((LlamaConfig, Llama), (GPT2Config, GPT2),
                             (MixtralConfig, Mixtral),
                             (ResNetConfig, ResNet)):
        if isinstance(config, cfg_type):
            return module(config, device=device, param_dtype=param_dtype)
    raise TypeError(f'No module builder for config type {type(config)}')


def is_causal_lm(config: Any) -> bool:
    """True for the families the trainer and the engine take."""
    return isinstance(config, (LlamaConfig, GPT2Config, MixtralConfig))


def rank_config(config: Any, tensor: int) -> Any:
    """`config` as one rank of a tensor-parallel split of degree `tensor`
    (``llama.RankConfig``, ``mixtral.MixtralRankConfig``,
    ``gpt2.GPT2RankConfig``): the model built from it holds the rank's
    slice of the weights (serving)."""
    cls = (MixtralRankConfig if isinstance(config, MixtralConfig) else
           GPT2RankConfig if isinstance(config, GPT2Config) else RankConfig)
    return cls(**{f.name: getattr(config, f.name)
                  for f in dataclasses.fields(config)},
               tensor_parallel=tensor)
