"""Checkpoints of nested dicts of numpy arrays and torch tensors
(``repro.distributed.checkpoint``'s counterpart and layout).

Layout: one ``shard_<process_index>.npz`` per writing process and, from
process 0, a ``manifest.json`` holding ``step`` and each leaf's shape and
dtype.  A leaf's key is its path joined with ``/``: dict keys in sorted
order (as ``jax.tree_util`` flattens a dict), sequence positions as
integers, NamedTuple fields as ``.<name>``.  So a checkpoint written by
either package restores in the other, leaf for leaf.

The JAX package's ``restore_checkpoint(..., shardings=)`` re-shards the
restored leaves onto a JAX device mesh; the port has no mesh yet, so the
argument is absent here (it comes with the port's sharding module).  A
restored leaf is a numpy array, or a torch tensor on the device of the
matching leaf of ``state_like`` when that is one.  The training loop
(``launch/train.py``) saves and restores its ``TrainState`` here, and a
``TrainState`` the JAX package wrote restores into the port's.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, prefix: tuple = ()) -> List[Tuple[str, Any]]:
    """[(key, leaf)] in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [item for name, x in zip(tree._fields, tree)
                for item in _flatten(x, prefix + ("." + name,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, x in enumerate(tree)
                for item in _flatten(x, prefix + (str(i),))]
    return [(SEP.join(prefix), tree)]


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with ``leaves`` (an iterator) in flatten
    order; a dict comes back with its keys sorted."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, state: Any, step: int,
                    process_index: int = 0) -> None:
    """Write this process's shard and (process 0) the manifest."""
    os.makedirs(path, exist_ok=True)
    chunks: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {"step": int(step), "leaves": {}}
    for key, leaf in _flatten(state):
        arr = _to_numpy(leaf)
        manifest["leaves"][key] = {
            "shape": list(arr.shape), "dtype": str(arr.dtype)}
        chunks[key] = arr
    np.savez(os.path.join(path, f"shard_{process_index}.npz"), **chunks)
    if process_index == 0:
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)


def restore_checkpoint(path: str, state_like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``state_like``: (tree, step).  Every
    leaf of ``state_like`` must be in the checkpoint with its shape."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data: Dict[str, np.ndarray] = {}
    i = 0
    while os.path.exists(os.path.join(path, f"shard_{i}.npz")):
        with np.load(os.path.join(path, f"shard_{i}.npz")) as z:
            for k in z.files:
                data[k] = z[k]
        i += 1
    leaves = []
    for key, like in _flatten(state_like):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        want = tuple(like.shape)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape} != expected {want}")
        if isinstance(like, torch.Tensor):
            arr = torch.from_numpy(arr).to(like.device)
        leaves.append(arr)
    return _unflatten(state_like, iter(leaves)), manifest["step"]


def latest_step_dir(root: str) -> str | None:
    """The ``step_<n>`` directory under ``root`` with the largest n."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.startswith("step_")]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=lambda d: int(d.split("_")[1])))
