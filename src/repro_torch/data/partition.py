"""Federated data partitioning (survey §3.3.1(3)): IID vs non-IID splits
(the JAX package's ``data/partition.py``; numpy ``RandomState``, so the
arrays equal the reference's).

Non-IID uses the standard Dirichlet(alpha) label-skew construction: lower
alpha => each client's label distribution is more concentrated, reproducing
the regime where Nilsson et al. [130] find FedAvg degrades vs centralized.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def make_classification_data(n: int, dim: int, n_classes: int, seed: int = 0
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian blobs; linearly separable-ish so small MLPs converge fast."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_classes, dim) * 3.0
    y = rng.randint(0, n_classes, size=n)
    X = centers[y] + rng.randn(n, dim)
    return X.astype(np.float32), y.astype(np.int32)


def iid_partition(n: int, num_clients: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(idx, num_clients)]


def dirichlet_partition(labels: np.ndarray, num_clients: int,
                        alpha: float = 0.5, seed: int = 0,
                        min_per_client: int = 2) -> List[np.ndarray]:
    """Label-skewed non-IID partition via per-class Dirichlet proportions."""
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    client_idx: List[List[int]] = [[] for _ in range(num_clients)]
    for c in range(n_classes):
        idx_c = np.where(labels == c)[0]
        rng.shuffle(idx_c)
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
        for client, part in enumerate(np.split(idx_c, cuts)):
            client_idx[client].extend(part.tolist())
    # ensure no client is empty
    for ci in range(num_clients):
        while len(client_idx[ci]) < min_per_client:
            donor = int(np.argmax([len(x) for x in client_idx]))
            client_idx[ci].append(client_idx[donor].pop())
    return [np.sort(np.array(ix, dtype=np.int64)) for ix in client_idx]


def stream_assignment(n_streams: int, num_workers: int,
                      seed: int = 0) -> List[List[int]]:
    """Deterministic worker→streams map for elastic resizing.

    A job keeps ``n_streams`` logical data streams (one per worker at its
    nominal size); when the scheduler resizes it to ``num_workers``, each
    worker slot covers an ordered list of streams: its own at nominal
    size, one ``iid_partition`` part when shrunk (the M workers *cover*
    all N streams, rotating within their part), round-robin wrap when
    grown beyond the stream count.  Pure in (n_streams, num_workers,
    seed), so the sim and device backends repartition identically."""
    if num_workers == n_streams:
        return [[s] for s in range(n_streams)]
    if num_workers < n_streams:
        parts = iid_partition(n_streams, num_workers, seed)
        return [[int(s) for s in p] for p in parts]
    return [[w % n_streams] for w in range(num_workers)]


def label_skew(partitions: List[np.ndarray], labels: np.ndarray) -> float:
    """Mean total-variation distance of client label dists from global."""
    n_classes = int(labels.max()) + 1
    global_p = np.bincount(labels, minlength=n_classes) / len(labels)
    tvs = []
    for part in partitions:
        p = np.bincount(labels[part], minlength=n_classes) / max(len(part), 1)
        tvs.append(0.5 * np.abs(p - global_p).sum())
    return float(np.mean(tvs))
