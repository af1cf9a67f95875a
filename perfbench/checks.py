"""The comparisons that decide ``correct``: each reads one number from the
program's and the reference's outputs, to be held against its limit in
``perfbench/limits/<workload>.json``."""
from __future__ import annotations

from typing import Dict, Sequence

from perfbench.stats import median

# a weight whose reference gradient is below this share of the median
# weight's moves by round-off alone (a bias under softmax) and is not read
NEGLIGIBLE = 1e-3


def rel_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    """The widest gap ``|a - b| / |b|`` over paired readings."""
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref))


def counted(ref_grad: Dict[str, float]) -> list:
    """The weights a per-weight comparison reads."""
    floor = NEGLIGIBLE * median(list(ref_grad.values()))
    return [n for n, g in ref_grad.items() if g >= floor]


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             ref_grad: Dict[str, float]) -> float:
    """The worst weight's gap between the program's norm and the
    reference's, over the larger of that weight's reference norm and the
    median weight's."""
    names = counted(ref_grad)
    mid = median([ref[n] for n in names])
    return max(abs(prog[n] - ref[n]) / max(ref[n], mid) for n in names)
