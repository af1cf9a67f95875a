"""How the benchmark hands its inputs to the program under test, the
PyTorch and CUDA package ``repro_torch``: the model configuration a
configuration file's ``port`` section names, and the benchmark's weights
laid out as the program's parameter tree (the same tensors, no copies).
The program's own bias leaves that the published architecture lacks get
zeros, so the program computes the published model."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


def model_config(cfg: Dict):
    """The program's ``ModelConfig`` for a configuration file: the named
    base config with the ``port`` section's fields over it."""
    from repro_torch.configs import get_config
    port = dict(cfg["port"])
    base = get_config(port.pop("config"))
    if "mrope_sections" in port:
        port["mrope_sections"] = tuple(port["mrope_sections"])
    return dataclasses.replace(base, **port)


def _dense(W, name, bias_name, use_bias, like):
    p = {"w": W[name]}
    if use_bias:
        p["b"] = W[bias_name] if bias_name in W else torch.zeros(
            like.shape[1], dtype=like.dtype, device=like.device)
    return p


def params(W: Dict[str, torch.Tensor], mcfg) -> Dict:
    """The program's parameter tree over the benchmark's weights ``W``."""
    ub = mcfg.use_bias
    tree = {"embed": W["embed"],
            "final_norm": {k: W[f"final_norm.{k}"] for k in ("scale", "bias")
                           if f"final_norm.{k}" in W}}
    if "lm_head" in W:
        tree["lm_head"] = W["lm_head"]
    layers = []
    for i in range(mcfg.num_layers):
        p = f"layers.{i}."
        norm = lambda n: {k: W[p + f"{n}.{k}"] for k in ("scale", "bias")  # noqa: E731
                          if p + f"{n}.{k}" in W}
        mixer = {n: _dense(W, p + n, p + "b" + n[1], ub, W[p + n])
                 for n in ("wq", "wk", "wv")}
        mixer["wo"] = _dense(W, p + "wo", None, ub, W[p + "wo"])
        mlp = {n: _dense(W, p + n, None, ub, W[p + n])
               for n in ("w_gate", "w_up", "w_down")}
        layers.append({"ln1": norm("ln1"), "ln2": norm("ln2"),
                       "mixer": mixer, "mlp": mlp})
    tree["layers"] = layers
    return tree


def weight_name(path: Tuple) -> Optional[str]:
    """The benchmark's name of the program's parameter at ``path``; None
    for a leaf of the program's that the published model lacks."""
    if path[0] != "layers":
        return ".".join(path)
    i, rest = path[1], path[2:]
    if rest[0] in ("ln1", "ln2"):
        return f"layers.{i}.{rest[0]}.{rest[1]}"
    kind, leaf = rest[1], rest[2]
    if leaf == "w":
        return f"layers.{i}.{kind}"
    if kind in ("wq", "wk", "wv"):
        return f"layers.{i}.b{kind[1]}"
    return None
