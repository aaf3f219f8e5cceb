"""Inference of the port: the dense-cache engine, offline ``generate``."""
from skypilot_tpu_torch.infer.engine import (InferConfig, InferenceEngine,
                                             Request, RequestResult,
                                             engine_from_name)

__all__ = ['InferConfig', 'InferenceEngine', 'Request', 'RequestResult',
           'engine_from_name']
