"""Meshes over logical devices (the JAX package's ``launch/mesh.py``) and
the H100's roofline constants.

The reference lays real or virtual XLA devices out as a
``jax.sharding.Mesh``; the port's devices are logical (every one of them
computes on the one card the engine runs on), so a mesh is the grid of
their ids.  ``make_production_mesh`` is the dry-run's 16 x 16 or 2 x 16 x
16 mesh of axis names and sizes: it names devices that need not exist,
so unlike the reference's it checks no device count.  The constants are
one H100 SXM's, dense, from NVIDIA's data sheet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

# H100 SXM hardware constants for the roofline analysis (per card, dense)
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12               # B/s, HBM3
NVLINK_BW = 450e9              # B/s each way, NVLink 4 (18 links)


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


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """Single pod: 16 x 16 = 256 devices ("data", "model").  Multi-pod:
    2 x 16 x 16 = 512 devices ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(np.arange(int(np.prod(shape))).reshape(shape), axes)


def make_host_mesh(model_axis: int = 1) -> LogicalMesh:
    """The ("data", "model") mesh over the cards this host has."""
    import torch
    n = torch.cuda.device_count()
    if n < model_axis or n % model_axis:
        raise ValueError(f"{n} cards cannot make a model axis of "
                         f"{model_axis}")
    return LogicalMesh(np.arange(n).reshape(n // model_axis, model_axis),
                       ("data", "model"))
