"""Checkpoints of nested dicts of numpy arrays and torch tensors
(``repro.distributed.checkpoint``'s counterpart and layout).

Layout: one ``shard_<process_index>.npz`` per writing process and, from
process 0, a ``manifest.json`` holding ``step`` and each leaf's shape and
dtype.  A leaf's key is its path joined with ``/``: dict keys in sorted
order (as ``jax.tree_util`` flattens a dict), sequence positions as
integers, NamedTuple fields as ``.<name>``.  So a checkpoint written by
either package restores in the other, leaf for leaf.

A restored leaf is a numpy array, or a torch tensor on the device of the
matching leaf of ``state_like`` when that is one.  The training loop
(``launch/train.py``) saves and restores its ``TrainState`` here, and a
``TrainState`` the JAX package wrote restores into the port's.

On a device mesh (``models/sharding.py``) a state's leaves are the rank's
shards.  ``save_checkpoint(..., shardings=)`` gathers the leaves whole,
one at a time (a collective: every rank calls it), and process 0 writes
each as it comes, so no shard is ever written as a partial leaf, the
checkpoint stays leaf for leaf the JAX package's, and no rank holds more
than one whole leaf.  ``restore_checkpoint(..., shardings=)`` re-shards
the restored leaves onto a mesh that may differ from the writer's (the
elastic downsize: a pod mesh's checkpoint onto a one-pod mesh), giving
each rank its shard of each leaf.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.models.sharding import NamedSharding, gather

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


def _flat_shardings(shardings):
    out = []

    def walk(t):
        if isinstance(t, NamedSharding):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            for x in t:
                walk(x)
    walk(shardings)
    return out


def _write_npz(path: str, leaves) -> Dict[str, Any]:
    """``np.savez``'s file from ``(key, array)`` pairs, each written as it
    comes (so only one is held at a time); returns each key's shape and
    dtype."""
    meta: Dict[str, Any] = {}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in leaves:
            meta[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
    return meta


def save_checkpoint(path: str, state: Any, step: int,
                    process_index: int = 0, shardings: Any = None) -> None:
    """Write this process's shard and (process 0) the manifest.  With
    ``shardings`` (a tree of ``NamedSharding`` over ``state``'s structure,
    ``state`` the rank's shards) the leaves are gathered whole one at a
    time (a collective: every rank calls it) and only process 0 writes
    each as it comes."""
    flat = _flatten(state)
    leaves = ((key, _to_numpy(leaf)) for key, leaf in flat)
    if shardings is not None:
        leaves = ((key, _to_numpy(gather(leaf, s.spec, s.mesh,
                                         differentiable=False)))
                  for (key, leaf), s in zip(flat,
                                            _flat_shardings(shardings)))
        if process_index != 0:
            for _ in leaves:            # the other ranks' part of each gather
                pass
            return
    os.makedirs(path, exist_ok=True)
    meta = _write_npz(os.path.join(path, f"shard_{process_index}.npz"),
                      leaves)
    if process_index == 0:
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump({"step": int(step), "leaves": meta}, f)


def restore_checkpoint(path: str, state_like: Any,
                       shardings: Any = None) -> Tuple[Any, int]:
    """Restore into the structure of ``state_like``: (tree, step).  Every
    leaf of ``state_like`` must be in the checkpoint with its shape; with
    ``shardings`` (a tree of ``NamedSharding`` on the new mesh),
    ``state_like`` holds the rank's shards there and each restored leaf
    is cut to this rank's shard of it.  The leaves are read one at a
    time."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    files, where = [], {}
    try:
        i = 0
        while os.path.exists(os.path.join(path, f"shard_{i}.npz")):
            files.append(np.load(os.path.join(path, f"shard_{i}.npz")))
            where.update(dict.fromkeys(files[-1].files, files[-1]))
            i += 1
        flat_like = _flatten(state_like)
        flat_shard = (_flat_shardings(shardings) if shardings is not None
                      else [None] * len(flat_like))
        leaves = []
        for (key, like), sharding in zip(flat_like, flat_shard):
            if key not in where:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = where[key][key]
            if sharding is not None:
                arr = np.array(arr[sharding.slices(arr.shape)])
            want = tuple(like.shape)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != expected {want}")
            if isinstance(like, torch.Tensor):
                arr = torch.from_numpy(arr).to(like.device)
            leaves.append(arr)
    finally:
        for z in files:
            z.close()
    return _unflatten(state_like, iter(leaves)), manifest["step"]


def latest_step_dir(root: str) -> str | None:
    """The ``step_<n>`` directory under ``root`` with the largest n."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.startswith("step_")]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=lambda d: int(d.split("_")[1])))
