"""ModelDB/ModelHub-style model registry (the JAX package's
``checkpoint/registry.py``; survey §3.5.2, [177, 116]): tracking,
indexing, and querying of trained models + their metadata in a plain
JSON index (``<root>/index.json``), the same file in both packages."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class ModelRegistry:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._index_path = os.path.join(root, "index.json")
        self._index: List[Dict[str, Any]] = []
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    def _persist(self):
        with open(self._index_path, "w") as f:
            json.dump(self._index, f, indent=1)

    def register(self, name: str, checkpoint_path: str, *,
                 arch: str = "", hyperparams: Optional[Dict] = None,
                 metrics: Optional[Dict] = None, parent: Optional[str] = None,
                 timestamp: Optional[float] = None) -> str:
        version = sum(1 for r in self._index if r["name"] == name)
        rec = {"id": f"{name}:v{version}", "name": name, "version": version,
               "checkpoint": checkpoint_path, "arch": arch,
               "hyperparams": hyperparams or {}, "metrics": metrics or {},
               "parent": parent,
               "created": timestamp if timestamp is not None else time.time()}
        self._index.append(rec)
        self._persist()
        return rec["id"]

    def get(self, model_id: str) -> Dict[str, Any]:
        for r in self._index:
            if r["id"] == model_id:
                return r
        raise KeyError(model_id)

    def query(self, *, name: Optional[str] = None, arch: Optional[str] = None,
              min_metric: Optional[Dict[str, float]] = None
              ) -> List[Dict[str, Any]]:
        out = []
        for r in self._index:
            if name and r["name"] != name:
                continue
            if arch and r["arch"] != arch:
                continue
            if min_metric and any(r["metrics"].get(k, float("-inf")) < v
                                  for k, v in min_metric.items()):
                continue
            out.append(r)
        return out

    def lineage(self, model_id: str) -> List[str]:
        chain = []
        cur: Optional[str] = model_id
        while cur:
            rec = self.get(cur)
            chain.append(cur)
            cur = rec["parent"]
        return chain

    def best(self, name: str, metric: str, maximize: bool = True
             ) -> Optional[Dict[str, Any]]:
        cands = [r for r in self.query(name=name) if metric in r["metrics"]]
        if not cands:
            return None
        return (max if maximize else min)(
            cands, key=lambda r: r["metrics"][metric])
