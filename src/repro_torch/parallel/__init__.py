"""Hybrid-parallel subsystem (survey §3.2; the JAX package's
``parallel``): data x tensor x stage meshes of logical devices with ZeRO
optimizer-state sharding, as a declarative Strategy dimension.

  mesh_plan.py  MeshSpec geometry + suffix grammar (``d2.t2.s2.z3.adamw``)
                and MeshPlan, the composition plan (role-based tensor
                shards, micro-batching, the shared data-axis bucket plan,
                ZeRO shard sizes)
  staged.py     StagedModel contract, the Megatron collectives as autograd
                Functions over the logical tensor axis, and the tiny
                transformer-FFN reference model
  zero.py       ZeRO-1/2/3 sharded update over the data axis through
                core/parameter_server.py's reduce-scatter path (SGD, AdamW)
  engine.py     HybridEngine: one train step over the 3-axis mesh,
                speaking the Engine / elastic protocol
"""
from repro_torch.parallel.engine import HybridConfig, HybridEngine
from repro_torch.parallel.mesh_plan import (AXES, MeshPlan, MeshSpec,
                                            parse_suffix, plan_mesh,
                                            suffix_spec)
from repro_torch.parallel.staged import (StagedModel, is_staged_model,
                                         make_tiny_transformer,
                                         stacked_grad_fn, stacked_loss,
                                         tensor_copy)
from repro_torch.parallel.zero import (make_zero_bucket_update,
                                       state_bytes_per_device,
                                       wire_bytes_per_device)

__all__ = [
    "AXES", "MeshSpec", "MeshPlan", "parse_suffix", "suffix_spec",
    "plan_mesh", "StagedModel", "is_staged_model", "make_tiny_transformer",
    "stacked_grad_fn", "stacked_loss", "tensor_copy", "HybridConfig",
    "HybridEngine", "make_zero_bucket_update", "state_bytes_per_device",
    "wire_bytes_per_device",
]
