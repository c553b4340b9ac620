"""Device meshes (the JAX package's ``launch/mesh.py``).

A real mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group, row-major (rank = the mesh
coordinate's row-major index, as ``jax.make_mesh`` lays the host devices
out), with the production axis names: ``("data", "model")`` or
``("pod", "data", "model")``.  It is built on ``cuda`` unless the caller
asks for ``cpu``.  The process group is the caller's
(``torch.distributed.init_process_group``, e.g. under ``torchrun``), with
one exception: a one-rank mesh with no group in the process starts a
one-process gloo group on an in-process store (no socket), so that
``make_host_mesh()`` runs anywhere, as in the JAX package.

``make_production_mesh`` cannot build 256 or 512 ranks: it returns a
:class:`ShapeMesh`, axis names and sizes with no process group, which
``models/sharding.py`` reads as it reads a real mesh.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --reduced --arch olmoe-1b-7b --model-parallel 2
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


class ShapeMesh:
    """A mesh's axis names and sizes with no ranks behind them (the
    production meshes; the JAX tests' ``FakeMesh``).  It answers what
    ``models/sharding.py`` asks of a mesh: ``mesh_dim_names``, ``shape``
    and ``size()``."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                             f"differ in length")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(axes)

    def size(self) -> int:
        return math.prod(self.shape)

    def __repr__(self) -> str:
        return f"ShapeMesh({dict(zip(self.mesh_dim_names, self.shape))})"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or a ShapeMesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _one_rank_group() -> None:
    """A one-process gloo group on an in-process store: what a one-rank
    mesh runs on where the caller started no group."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)


def compat_mesh(shape: Sequence[int], axes: Sequence[str],
                device: str = "cuda") -> DeviceMesh:
    """A DeviceMesh of ``shape`` named ``axes`` over the default group's
    ranks, on ``device``'s type (``cuda`` unless the caller asks for
    ``cpu``).  The group must hold exactly prod(shape) ranks."""
    n = math.prod(shape)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: build the mesh with "
                           "device='cpu' to run on the CPU")
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs a torch.distributed process "
                f"group (init_process_group, or torchrun)")
        _one_rank_group()
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; the "
                         f"process group holds {world}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """16x16 single pod (256 chips) or 2x16x16 (2 pods, 512 chips), as a
    shape-only mesh.

    Axes: ``pod`` — pure data parallelism across pods (params replicated,
    only the gradient all-reduce crosses pods); ``data`` — FSDP + batch;
    ``model`` — TP/EP."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))


def make_host_mesh(device: str = "cuda") -> DeviceMesh:
    """1-rank mesh with the production axis names."""
    return compat_mesh((1, 1), ("data", "model"), device)


def make_mesh_for(n_devices: int, model_parallel: int = 1,
                  device: str = "cuda") -> DeviceMesh:
    """A (n_devices / model_parallel, model_parallel) ("data", "model")
    mesh over the process group's ranks."""
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} ranks do not split into model "
                         f"parallelism {model_parallel}")
    return compat_mesh((n_devices // model_parallel, model_parallel),
                       ("data", "model"), device)


def coordinate(mesh) -> Dict[str, int]:
    """{axis name: this rank's index} on a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def axis_group(mesh: DeviceMesh, axes) -> dist.ProcessGroup:
    """The process group of this rank along ``axes`` (a name, or a tuple of
    names in mesh order), its ranks in row-major order of the mesh
    coordinate over ``axes``.  A tuple's groups are created once per mesh:
    every rank creates every group of the partition, in one order, as
    ``torch.distributed.new_group`` requires."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = mesh.mesh_dim_names
    dims = [names.index(a) for a in axes]
    if dims != sorted(dims):
        raise ValueError(f"axes {axes} are not in mesh order {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups: Dict[Tuple[str, ...], dist.ProcessGroup] = \
        mesh.__dict__.setdefault("_axis_groups", {})
    if axes not in groups:
        other = [i for i in range(len(names)) if i not in dims]
        size = math.prod(mesh.mesh.shape[d] for d in dims)
        rows = mesh.mesh.permute(*other, *dims).reshape(-1, size).tolist()
        me = dist.get_rank()
        for row in rows:
            group = dist.new_group(row)
            if me in row:
                groups[axes] = group
    return groups[axes]
