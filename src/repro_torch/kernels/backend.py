"""Kernel backend seam: one rule for every kernel-vs-plain choice.

Every hot spot with a hand-written kernel takes a ``backend`` knob:

  kernel   the CUDA kernel.  Only tensors on a CUDA device can take it;
           asking for it with a CPU tensor raises.
  ref      the plain PyTorch version of the same math.  On the card it
           runs only where a caller names it (``chip_smoke.py``'s
           comparison run); the tests run it on the CPU.
  auto     ``kernel`` for CUDA tensors, ``ref`` for CPU tensors.

The choice follows the tensor's device and nothing else: no environment
variable can move the card path off the kernels, and a failed build or
launch raises instead of falling back to the plain version.

Tensors on the ``meta`` device (shapes, no storage) take ``ref`` too,
so the dry-run's operation count sees the plain version's products.
Inside ``meta_as_card()`` they take the kernel route instead, and the
flash entries return their outputs' shapes: the dry-run's count of the
bytes a card run keeps live (``launch.cost.MetaMemory``).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_META_AS_CARD = contextvars.ContextVar("meta_as_card", default=False)


@contextlib.contextmanager
def meta_as_card():
    """Within the block, meta tensors resolve as CUDA tensors do."""
    token = _META_AS_CARD.set(True)
    try:
        yield
    finally:
        _META_AS_CARD.reset(token)


def on_card(tensor: torch.Tensor) -> bool:
    """Whether ``tensor`` takes the kernel route under ``auto``."""
    return tensor.device.type == "cuda" or (
        tensor.device.type == "meta" and _META_AS_CARD.get())

KERNEL_BACKENDS = ("auto", "kernel", "ref")


def resolve_backend(backend: str, tensor: torch.Tensor) -> str:
    """Resolve a backend knob to ``"kernel"`` or ``"ref"`` for ``tensor``."""
    if backend not in KERNEL_BACKENDS:
        raise ValueError(
            f"backend={backend!r} (want one of {KERNEL_BACKENDS})")
    on_cuda = on_card(tensor)
    if backend == "auto":
        return "kernel" if on_cuda else "ref"
    if backend == "kernel" and not on_cuda:
        raise ValueError(
            f"backend='kernel' needs a CUDA tensor, got one on {tensor.device}")
    return backend
