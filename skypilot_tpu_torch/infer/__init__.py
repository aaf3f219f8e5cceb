"""Inference of the port: the dense-cache engine (offline ``generate`` and
the serving loop ``generate_stream``), deterministic fault injection, and
the HTTP server (``infer.server``)."""
from skypilot_tpu_torch.infer.engine import (InferConfig, InferenceEngine,
                                             Request, RequestResult,
                                             engine_from_name)
from skypilot_tpu_torch.infer.faults import (FaultPlan, FaultSpec,
                                             InjectedFault)

__all__ = ['InferConfig', 'InferenceEngine', 'Request', 'RequestResult',
           'engine_from_name', 'FaultPlan', 'FaultSpec', 'InjectedFault']
