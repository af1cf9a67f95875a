"""Federated learning (survey §3.3.1(3)) on the port: FedAvg on IID vs
Dirichlet non-IID client splits of a seeded classification set, with a
two-layer tanh MLP, showing the degradation Nilsson et al. [130] report
for the non-IID regime (the JAX package's examples/federated_noniid.py).

  PYTHONPATH=src python tools/torch_federated_noniid.py [--device cpu]
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core.federated import FedConfig, run_fedavg  # noqa: E402
from repro_torch.data.partition import (  # noqa: E402
    dirichlet_partition, iid_partition, label_skew, make_classification_data)

N, DIM, CLASSES, CLIENTS = 1500, 16, 8, 10


def mlp_grad_fn(params, batch):
    """(loss, grads) of the MLP's mean cross-entropy on ``batch``."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    logits = torch.tanh(batch["X"] @ leaves["w1"]) @ leaves["w2"]
    loss = torch.nn.functional.cross_entropy(logits, batch["y"])
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def client_batches(X, y, parts, device):
    """client c's batch of step s: 32 rows drawn from its shard by
    ``RandomState(s)`` (the reference example's draw)."""
    fns = []
    for idx in parts:
        def fn(step, idx=idx):
            rng = np.random.RandomState(step)
            sel = idx[rng.randint(0, len(idx), size=min(32, len(idx)))]
            return {"X": torch.from_numpy(X[sel]).to(device),
                    "y": torch.from_numpy(y[sel]).long().to(device)}
        fns.append(fn)
    return fns


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=15)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    X, y = make_classification_data(N, DIM, CLASSES, seed=0)
    gen = torch.Generator().manual_seed(1)
    p0 = {"w1": (torch.randn(DIM, 32, generator=gen) * 0.2).to(dev),
          "w2": (torch.randn(32, CLASSES, generator=gen) * 0.2).to(dev)}
    cfg = FedConfig(num_clients=CLIENTS, clients_per_round=5, local_steps=4,
                    local_lr=0.1)
    for name, parts in [
            ("iid", iid_partition(N, CLIENTS, seed=0)),
            ("non-iid (alpha=0.1)", dirichlet_partition(y, CLIENTS, 0.1,
                                                        seed=0))]:
        _, hist = run_fedavg(p0, client_batches(X, y, parts, dev),
                             mlp_grad_fn, cfg, args.rounds)
        print(f"{name:22s} skew={label_skew(parts, y):.2f}  "
              f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
