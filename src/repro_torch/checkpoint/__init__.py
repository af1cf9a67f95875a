"""Model-data management (survey §3.5.2): sharded checkpoints + a
ModelDB-style registry (the JAX package's ``checkpoint``)."""
from repro_torch.checkpoint.registry import ModelRegistry
from repro_torch.checkpoint.store import (is_valid_checkpoint,
                                          load_checkpoint, read_manifest,
                                          save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "read_manifest",
           "is_valid_checkpoint", "ModelRegistry"]
