"""The hybrid-parallel training mesh over logical devices (the JAX
package's ``launch/mesh.py::make_hybrid_mesh``).

The reference lays real or virtual XLA devices out as a
``jax.sharding.Mesh``; the port's devices are logical (every one of them
computes on the one card the engine runs on), so a mesh is the grid of
their ids.  The reference's production and host meshes and its TPU
roofline constants are XLA device meshes and are not ported (ROADMAP
queue A item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """``devices[d, t, s]`` is the id of the logical device at data slot
    d, tensor rank t, stage s."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]


def make_hybrid_mesh(data: int, tensor: int, stage: int,
                     devices: Optional[Sequence[int]] = None,
                     axes=("data", "tensor", "stage")) -> LogicalMesh:
    """The ``data`` x ``tensor`` x ``stage`` mesh over ``devices``
    (logical ids, ``range(data * tensor * stage)`` by default).  Device
    order is data-major, so a data-axis resize keeps (tensor, stage)
    blocks contiguous and device ``w`` belongs to data slot
    ``w // (tensor * stage)``."""
    n = data * tensor * stage
    devices = list(range(n)) if devices is None else list(devices)
    if len(devices) < n:
        raise ValueError(f"mesh {data}x{tensor}x{stage} needs {n} devices, "
                         f"have {len(devices)}")
    return LogicalMesh(np.array(devices[:n]).reshape(data, tensor, stage),
                       tuple(axes))
