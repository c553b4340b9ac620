"""Sharding rules: parameter / batch / cache specs per architecture (the
JAX package's ``models/sharding.py``), and the shards they give a rank.

A spec is a tuple with one entry per dimension: an axis name, a tuple of
axis names (sharded over their product, row-major), or ``None``
(replicated); the JAX ``PartitionSpec``'s entries, leaf for leaf.

Policy (as in the JAX package):
* ``model`` axis carries tensor parallelism (attention heads, d_ff, experts,
  vocab) whenever the dimension divides evenly; otherwise that tensor falls
  back to FSDP-only storage sharding.
* ``data`` axis carries FSDP (parameters + optimizer states sharded on their
  largest non-TP dim) and the batch.
* ``pod`` axis (multi-pod mesh) is pure data parallelism: parameters are
  replicated across pods, so the only cross-pod traffic is the gradient
  all-reduce — batch specs use ``(("pod", "data"), ...)``.

Everything is divisibility-checked against the mesh (``_ok``), real
(``DeviceMesh``) or shape-only (``launch.mesh.ShapeMesh``), so the same
code serves the production meshes and a rank's run.

Where the port computes on these layouts: a rank holds each state leaf's
shard (:func:`shard`, :func:`shard_slices`), and the train step and the
serving steps gather the leaves they compute with (:class:`Gatherer`), a
stacked layer's as the layer runs.  The experts stay sharded over
``model`` (the moe layer's expert parallelism); every other layer computes
on its weights gathered whole and on its rank's batch rows
(:func:`batch_rows`), which is the layout ``_constrain_act`` pins in the
JAX package.  Heads and ``d_ff`` split over ``model`` (tensor parallelism)
and the sequence split of ``seq_parallel`` are layouts of the same math
the port does not take yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.launch.mesh import axis_group, axis_sizes, coordinate
from repro_torch.models.config import ModelConfig, ShapeSpec

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
STACKED = ("blocks", "first_blocks")       # [L, ...] layer leaves


class P(tuple):
    """A spec (the JAX ``PartitionSpec``): a tuple of entries, one per
    dimension; a one-axis tuple entry is that axis, as JAX writes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"



def data_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _axis_size(mesh, n)
        return out
    return axis_sizes(mesh).get(name, 0)


def _ok(mesh, dim: int, axis) -> Any:
    """axis if ``dim`` divides evenly over it on this mesh, else None."""
    n = _axis_size(mesh, axis)
    return axis if n and dim % n == 0 and dim >= n else None


def map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *leaves)`` over a nested dict / tuple tree and
    trees of its structure; a path holds dict keys, and "" for a tuple
    position (as the JAX code's ``getattr(p, "key", getattr(p, "name",
    ""))`` reads a SequenceKey)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest),
                                 path=path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, P):
        return tuple(map_with_path(fn, *xs, path=path + ("",))
                     for xs in zip(tree, *rest))
    return fn(path, tree, *rest)


def param_specs(cfg: ModelConfig, params: Any, mesh) -> Any:
    """Spec tree mirroring ``params`` (any leaves with ``.shape``: tensors,
    meta tensors)."""

    def leaf_spec(names, leaf) -> P:
        name = names[-1]
        stacked = ("blocks" in names or "first_blocks" in names)
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        pre = (None,) if stacked else ()

        def spec(*axes):
            return P(*pre, *(_ok(mesh, dim, ax) if ax else None
                             for dim, ax in zip(shape, axes)))

        if name in ("ln1", "ln2", "final_norm", "norm_w", "A_log", "D",
                    "dt_bias", "conv_b", "bq", "bk", "bv"):
            return P(*pre, *([None] * len(shape)))
        if name == "embed":
            return spec("model", "data")
        if name == "unembed":
            return spec("data", "model")
        if name == "conv_w":
            return P(*pre, None, None)
        if name == "router":
            return spec("data", None)
        if name in ("w_gate", "w_up"):
            if len(shape) == 3:                      # experts [E, d, f]
                return spec("model", "data", None)
            return spec("data", "model")             # dense MLP [d, ff]
        if name == "w_down":
            if len(shape) == 3:                      # experts [E, f, d]
                return spec("model", None, "data")
            return spec("model", "data")             # dense MLP [ff, d]
        if name in ("wq", "wk", "wv", "w_dq", "w_dkv", "w_uq", "w_uk",
                    "w_uv", "in_proj"):
            return spec("data", "model")
        if name in ("wo", "out_proj"):
            return spec("model", "data")
        return P(*pre, *([None] * len(shape)))

    return map_with_path(leaf_spec, params)


def batch_axis(mesh, B: int, dp=None) -> Any:
    """The axes a global batch of ``B`` rows splits over: ``dp`` (the
    mesh's data axes by default) where B divides over them, else ``data``
    where it divides over that, else None (every rank holds all rows)."""
    dp = data_axes(mesh) if dp is None else tuple(dp)
    return _ok(mesh, B, dp) or _ok(mesh, B, "data")


def batch_rows(batch: Dict[str, torch.Tensor], mesh, dp=None):
    """This rank's rows of each leaf of a global batch, as
    :func:`batch_axis` splits them (views)."""
    out = {}
    for k, v in batch.items():
        rows = shard_slices(P(batch_axis(mesh, v.shape[0], dp)),
                            (v.shape[0],), mesh)[0]
        out[k] = v[rows]
    return out


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Dict[str, P]:
    """Specs for every input the shape's step consumes."""
    B = shape.global_batch
    bspec = batch_axis(mesh, B)
    if shape.kind == "decode":
        return {"tokens": P(bspec, None)}
    if cfg.frontend == "patch_embeds":
        return {"patch_embeds": P(bspec, None, None),
                "tokens": P(bspec, None), "labels": P(bspec, None)}
    if cfg.frontend == "frame_embeds":
        return {"frame_embeds": P(bspec, None, None),
                "labels": P(bspec, None)}
    return {"tokens": P(bspec, None), "labels": P(bspec, None)}


def cache_specs(cfg: ModelConfig, cache: Any, mesh, batch_size: int) -> Any:
    """Decode-cache specs: batch over data axes; heads over ``model`` when
    divisible, else the time axis over ``model`` (flash-decoding style)."""
    dp = data_axes(mesh)
    bax = _ok(mesh, batch_size, dp) or _ok(mesh, batch_size, "data")

    def leaf_spec(names, leaf) -> P:
        shape = tuple(leaf.shape)
        if "ssm" in names:
            if len(shape) == 5:      # h [L, B, H, P, N]
                return P(None, bax, _ok(mesh, shape[2], "model"), None, None)
            return P(None, bax, None, None)       # conv [L, B, W-1, ch]
        # attention caches: [n, B, T, Hkv, dh] or MLA [n, B, T, R]
        if len(shape) == 5:
            hax = _ok(mesh, shape[3], "model")
            tax = None if hax else _ok(mesh, shape[2], "model")
            return P(None, bax, tax, hax, None)
        if len(shape) == 4:          # MLA latent [n, B, T, R]
            return P(None, bax, _ok(mesh, shape[2], "model"), None)
        return P(*([None] * len(shape)))

    return map_with_path(leaf_spec, cache)


# ---------------------------------------------------------------------------
# A rank's shards
# ---------------------------------------------------------------------------
def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _index_over(entry, mesh, coord: Dict[str, int]) -> int:
    """The row-major index of ``coord`` over ``entry``'s axes."""
    sizes, idx = axis_sizes(mesh), 0
    for a in _axes_of(entry):
        idx = idx * sizes[a] + coord[a]
    return idx


def shard_slices(spec: P, shape, mesh, coord=None) -> Tuple[slice, ...]:
    """The slices of a leaf of global ``shape`` that the rank at ``coord``
    ({axis: index}; this rank's by default) holds under ``spec``."""
    coord = coordinate(mesh) if coord is None else coord
    out = []
    for dim, entry in zip(shape, spec):
        n = _axis_size(mesh, entry) if entry is not None else 1
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {entry} ({n})")
        step = dim // n
        i = _index_over(entry, mesh, coord)
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out) + (slice(None),) * (len(shape) - len(spec))


def shard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's shard of the global leaf ``x`` (a contiguous copy)."""
    return x[shard_slices(spec, x.shape, mesh)].contiguous()


def gather(x: torch.Tensor, spec: P, mesh,
           differentiable: bool = True) -> torch.Tensor:
    """The global leaf from this rank's shard ``x``: an all-gather along
    each sharded dimension over its axes (collective: every rank of the
    mesh calls it).  Differentiable, its adjoint the reduce-scatter."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        group = axis_group(mesh, _axes_of(entry))
        x = (coll.gather(x, dim, group) if differentiable
             else coll.all_gather(x, dim, group))
    return x


def spec_at(specs, path) -> P:
    """The spec of the leaf at ``path``; under a stacked ``path`` (see
    ``STACKED``) that of one layer of it."""
    for k in path:
        specs = specs[k]
    return P(*specs[1:]) if path[0] in STACKED else specs


def model_param_specs(cfg: ModelConfig, mesh) -> Any:
    """``param_specs`` of the arch's parameter tree on ``mesh``."""
    from repro_torch.models import transformer
    return param_specs(cfg, transformer.init_params(cfg, device="meta"),
                       mesh)


def shard_keeper(cfg: ModelConfig, mesh):
    """``keep(path, leaf)`` for ``transformer.init_params``: this rank's
    shard of each leaf as it is drawn (a stacked leaf a layer at a
    time)."""
    specs = model_param_specs(cfg, mesh)
    return lambda path, x: shard(x, spec_at(specs, path), mesh)


class Gatherer:
    """The parameters a rank computes with, from its shards (FSDP): every
    leaf gathered whole over the axes its spec splits, but the experts
    where the moe layer runs expert-parallel (the experts divide the
    ``model`` axis), which it keeps sharded over ``model`` and gathers
    over ``data`` itself.  ``differentiable``: the gathers' adjoint is the
    reduce-scatter (training)."""

    def __init__(self, cfg: ModelConfig, mesh, differentiable: bool = True):
        self.mesh, self.differentiable = mesh, differentiable
        self.specs = model_param_specs(cfg, mesh)
        n_model = axis_sizes(mesh).get("model", 1)
        self.ep = bool(cfg.n_experts) and cfg.n_experts % n_model == 0

    def leaf(self, path, x, spec):
        if self.ep and "moe" in path and "shared" not in path \
                and path[-1] in EXPERT_LEAVES:
            if spec[-3] != "model" or "data" not in spec:
                raise ValueError(f"{'/'.join(path)}: the experts must split "
                                 f"over 'model' and 'data', not {spec}")
            return x
        return gather(x, spec, self.mesh, self.differentiable)

    def fetch(self, name, layer):
        """One layer of the stacked leaves ``name``, its shards gathered
        (``transformer``'s stacks call it as the layer runs, inside a
        layer's remat unit in training)."""
        return map_with_path(
            lambda path, x: self.leaf(path, x, spec_at(self.specs, path)),
            layer, path=(name,))

    def top(self, params):
        """``params`` with every leaf outside the stacked layers
        gathered; the stacked ones as they are, for :meth:`fetch`."""
        return {k: v if k in STACKED else
                map_with_path(self.leaf, v, self.specs[k], path=(k,))
                for k, v in params.items()}


def replica_axes(spec: P, mesh) -> Tuple[str, ...]:
    """The mesh axes over which a leaf of ``spec`` is replicated, in mesh
    order: the ranks along them hold the same shard."""
    used = {a for entry in spec for a in _axes_of(entry)}
    return tuple(a for a in mesh.mesh_dim_names if a not in used)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout on a mesh (the JAX ``NamedSharding``)."""
    mesh: Any
    spec: P

    def slices(self, shape, coord=None):
        return shard_slices(self.spec, shape, self.mesh, coord)


def map_specs(fn, spec_tree, *rest):
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure."""
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, P):
        return fn(spec_tree, *rest)
    return type(spec_tree)(*(map_specs(fn, s, *xs) for s, *xs in
                             zip(spec_tree, *rest))) \
        if hasattr(spec_tree, "_fields") else tuple(
            map_specs(fn, s, *xs) for s, *xs in zip(spec_tree, *rest))


def to_shardings(spec_tree: Any, mesh) -> Any:
    return map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


def to_placements(spec: P, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh axis,
    ``Shard(dim)`` where a dimension is split over it, else
    ``Replicate()``.  A dimension split over several axes is split over
    them in mesh order (DTensor's nesting), as the JAX spec's tuple
    is.  The port's own layers compute on plain tensors and do not call
    it: it maps the specs for code that works with DTensor."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"spec entry {entry} is not in mesh order")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return out


def constrain(x: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    """``with_sharding_constraint``: a no-op on one device.  On a mesh a
    rank's activations are its batch shard, replicated over ``model`` —
    the layout ``P(data_axes, None, ...)`` pins, which is taken as is; a
    spec that splits another dimension over ``model`` (sequence
    parallelism) is a layout the port does not take yet, and raises.
    Nothing in the port calls it yet: it holds the JAX call's place and
    changes no computation."""
    if mesh is None or mesh.size() == 1:
        return x
    if any(e is not None for e in spec[1:]):
        raise NotImplementedError(
            f"constrain {spec}: the port keeps activations batch-sharded "
            f"and replicated over 'model'")
    return x
