"""Sharded npz checkpoints for the port's trees (the JAX package's
``checkpoint/store.py``, same on-disk format).

Layout: <dir>/manifest.json (leaf metadata + shard map) and
<dir>/shard_<i>.npz.  A tree is a nest of dicts, lists and tuples of
tensors; its leaves are taken in ``jax.tree.leaves`` order
(``core.tree.leaf_paths``: dict keys sorted, sequences in order), named by
their path joined with ``/`` and stored under ``name.replace("/",
"__")``.  ``None`` is an empty subtree, as in JAX.  Leaves fill shards in
order; a leaf that would take a shard past ``shard_bytes`` starts the
next one.  So the same tree saved by either package gives the same
manifest, per-leaf hashes included, and either package loads the other's
checkpoints.

Leaves are written from host memory: a CUDA tensor goes through
``.detach().cpu()`` on save, and ``load_checkpoint(path, like)`` puts each
leaf on the device of the matching ``like`` leaf (the CPU for a leaf that
is not a tensor).  numpy has no bfloat16: a bf16 leaf is stored as its
2-byte payload in a void array (``V2``, numpy's own ``|V2`` header where
the JAX package's ml_dtypes writes ``<V2``; the payload bytes are the
same) with manifest dtype ``"bfloat16"``, and reinterpreted by that
dtype on load.  The JAX package's own load hands such leaves back as
``V2`` void arrays; here they come back as ``torch.bfloat16``.

Writes are atomic: shards and manifest are staged into a sibling temp
directory which is then renamed into place with ``os.replace``, so a
crash mid-save never leaves a torn checkpoint.  The manifest carries an
optional ``extra`` JSON blob (``read_manifest``).

Incremental saves: ``incremental_from=<previous checkpoint dir>``
hard-links every shard whose leaf composition and content hashes are
unchanged since that checkpoint instead of re-serializing it (a copy on
filesystems without links).  The manifest records per-leaf sha256
content hashes (``hash``, over the numpy dtype name, the shape tuple and
the bytes) and the count of linked shards (``linked_shards``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import get_path, leaf_paths

_VOID2 = np.dtype("V2")
_WRITERS = 4              # shard files written at once


def _leaf_items(tree) -> List[Tuple[str, Any]]:
    """(name, leaf) of every leaf of ``tree`` in ``jax.tree.leaves``
    order; None leaves are empty subtrees and skipped."""
    out = []
    for path in leaf_paths(tree):
        leaf = get_path(tree, path)
        if leaf is not None:
            out.append(("/".join(map(str, path)), leaf))
    return out


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """(host numpy array, manifest dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_VOID2), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _leaf_hash(arr: np.ndarray, dtype: str) -> str:
    h = hashlib.sha256()
    h.update(dtype.encode())
    h.update(str(arr.shape).encode())
    # the array's own bytes (no copy of a contiguous leaf)
    h.update(memoryview(np.ascontiguousarray(arr).reshape(-1)).cast("B"))
    return h.hexdigest()


def _prev_shard_map(prev_dir: Optional[str]) -> Dict[int, List[dict]]:
    """shard index -> ordered leaf records of the previous manifest, or
    {} when there is no usable previous checkpoint."""
    if not prev_dir or not is_valid_checkpoint(prev_dir):
        return {}
    by_shard: Dict[int, List[dict]] = {}
    for rec in read_manifest(prev_dir)["leaves"]:
        by_shard.setdefault(rec["shard"], []).append(rec)
    return by_shard


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def _write_checkpoint(path: str, tree, step: int, shard_bytes: int,
                      extra: Optional[Dict],
                      prev_dir: Optional[str] = None,
                      hash_leaves: bool = False) -> Dict:
    os.makedirs(path, exist_ok=True)
    prev_shards = _prev_shard_map(prev_dir)
    # leaves hash and shards are written on worker threads (sha256, the
    # npz writer's CRC and the file writes release the GIL): a record has
    # its hash before anything reads it, at most WRITERS shards are in
    # flight, and the manifest waits for every shard
    pool = ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1)))
    writes: List[Any] = []

    def resolve(recs):
        for rec in recs:
            fut = rec.pop("_hash", None)
            if fut is not None:
                rec["hash"] = fut.result()

    manifest: Dict[str, Any] = {"step": step, "leaves": [], "shards": 0,
                                "linked_shards": 0}
    if extra is not None:
        manifest["extra"] = extra
    shard: Dict[str, np.ndarray] = {}
    shard_recs: List[dict] = []
    shard_size = 0
    shard_idx = 0

    def flush():
        nonlocal shard, shard_recs, shard_size, shard_idx
        if not shard:
            return
        # hash-skip: when this shard's composition (keys, shapes, dtypes,
        # content hashes) matches the previous checkpoint's shard of the
        # same index, link the old file instead of re-serializing it
        prev = prev_shards.get(shard_idx)
        if prev is not None:
            resolve(shard_recs)
        same = (prev is not None and len(prev) == len(shard_recs)
                and all(p.get("hash") and r.get("hash")
                        and p["key"] == r["key"]
                        and p["hash"] == r["hash"]
                        and p["shape"] == r["shape"]
                        and p["dtype"] == r["dtype"]
                        for p, r in zip(prev, shard_recs)))
        fname = f"shard_{shard_idx}.npz"
        if same:
            _link_or_copy(os.path.join(prev_dir, fname),
                          os.path.join(path, fname))
            manifest["linked_shards"] += 1
        else:
            while len(writes) >= _WRITERS:
                writes.pop(0).result()
            writes.append(pool.submit(np.savez, os.path.join(path, fname),
                                      **shard))
        resolve(shard_recs)
        shard_idx += 1
        shard, shard_recs, shard_size = {}, [], 0

    try:
        for name, leaf in _leaf_items(tree):
            arr, dtype = _host_array(leaf)
            key = name.replace("/", "__")
            if shard_size + arr.nbytes > shard_bytes:
                flush()
            shard[key] = arr
            shard_size += arr.nbytes
            rec = {"name": name, "key": key, "shard": shard_idx,
                   "shape": list(arr.shape), "dtype": dtype}
            if hash_leaves:
                rec["_hash"] = pool.submit(_leaf_hash, arr, dtype)
            shard_recs.append(rec)
            manifest["leaves"].append(rec)
        flush()
        for w in writes:
            w.result()
    finally:
        pool.shutdown()
    manifest["shards"] = shard_idx
    # manifest last: its presence is the per-directory commit marker
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


def save_checkpoint(path: str, tree, step: int = 0,
                    shard_bytes: int = 512 * 1024 * 1024,
                    extra: Optional[Dict] = None,
                    incremental_from: Optional[str] = None,
                    hash_leaves: Optional[bool] = None) -> Dict:
    """Atomically write ``tree`` to the checkpoint directory ``path``;
    returns the manifest.

    All files are staged into ``<path>.tmp.<pid>`` and swapped in with one
    ``os.replace``: a reader sees the complete old checkpoint, no
    checkpoint, or the complete new one.  An existing checkpoint is
    renamed aside to ``<path>.old.<pid>`` before the swap (renames keep
    the inodes staged links point at) and removed after it.

    ``incremental_from`` names a committed checkpoint whose unchanged
    shards are hard-linked instead of rewritten; restores are bitwise
    identical either way.  ``hash_leaves`` stores per-leaf content hashes
    so a later save can link against this one; it defaults to on exactly
    when ``incremental_from`` is given."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    if incremental_from is not None:
        incremental_from = os.path.abspath(incremental_from)
    if hash_leaves is None:
        hash_leaves = incremental_from is not None
    tmp = f"{path}.tmp.{os.getpid()}"
    old = f"{path}.old.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        manifest = _write_checkpoint(tmp, tree, step, shard_bytes, extra,
                                     prev_dir=incremental_from,
                                     hash_leaves=hash_leaves)
        if os.path.isdir(path):
            shutil.rmtree(old, ignore_errors=True)
            os.rename(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return manifest


def read_manifest(path: str) -> Dict:
    """The checkpoint's manifest (step, leaf metadata, ``extra`` blob).
    Raises FileNotFoundError for a missing or uncommitted checkpoint."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def is_valid_checkpoint(path: str) -> bool:
    """True iff ``path`` holds a committed (manifest-bearing) checkpoint."""
    return os.path.isfile(os.path.join(path, "manifest.json"))


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _rebuild(like, prefix: Tuple, leaves: Dict[str, torch.Tensor]):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, prefix + (k,), leaves)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, prefix + (i,), leaves)
                          for i, v in enumerate(like))
    t = leaves["/".join(map(str, prefix))]
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def load_checkpoint(path: str, like):
    """Restore into the structure of ``like``: (tree, step).  Each leaf is
    a tensor of the stored dtype on the device of ``like``'s leaf at the
    same path.  Where ``like`` holds None (an empty subtree) nothing is
    read, and the result holds None."""
    manifest = read_manifest(path)
    wanted = {"/".join(map(str, p)) for p in leaf_paths(like)
              if get_path(like, p) is not None}
    by_shard: Dict[int, List[dict]] = {}
    for rec in manifest["leaves"]:
        if rec["name"] in wanted:
            by_shard.setdefault(rec["shard"], []).append(rec)
    leaves: Dict[str, torch.Tensor] = {}
    for si, recs in by_shard.items():
        with np.load(os.path.join(path, f"shard_{si}.npz")) as z:
            for rec in recs:
                leaves[rec["name"]] = _to_tensor(z[rec["key"]], rec["dtype"])
    return _rebuild(like, (), leaves), manifest["step"]
