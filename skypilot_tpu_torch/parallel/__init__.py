"""Mesh parallelism of the port on torch.distributed: device meshes and
the logical sharding rules (``parallel.mesh``), GPipe pipelining
(``parallel.pipeline``).  The counterpart of ``skypilot_tpu.parallel``."""
from skypilot_tpu_torch.parallel.mesh import (MeshSpec,
                                              initialize_distributed_from_env,
                                              logical_axis_rules, make_mesh,
                                              mesh_context, tp_mesh)

__all__ = ['MeshSpec', 'initialize_distributed_from_env', 'make_mesh',
           'logical_axis_rules', 'mesh_context', 'tp_mesh']
