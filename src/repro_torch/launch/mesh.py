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
``models/sharding.py`` reads as it reads a real mesh.  A ShapeMesh has a
coordinate too (rank 0 unless the caller names another), and its
:func:`axis_group` is a ``collectives.ShapeGroup``: one rank's program
runs on it with ``meta`` tensors, its collectives communicating nothing
(``distributed/collectives.py``), which is how ``launch/dryrun.py``
traces a rank of the production meshes.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --reduced --arch olmoe-1b-7b --model-parallel 2
"""
from __future__ import annotations

import math
import os
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.distributed.collectives import ShapeGroup


class ShapeMesh:
    """A mesh's axis names and sizes with no ranks behind them (the
    production meshes; the JAX tests' ``FakeMesh``), seen from one rank:
    ``rank`` (0 by default) is the row-major index of its coordinate, as
    on a DeviceMesh.  It answers what ``models/sharding.py`` and the
    collectives ask of a mesh: ``mesh_dim_names``, ``shape``, ``size()``
    and ``get_coordinate()``."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 rank: int = 0):
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                             f"differ in length")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(axes)
        if not 0 <= rank < self.size():
            raise ValueError(f"rank {rank} is not on a mesh of "
                             f"{self.size()} ranks")
        self.rank = int(rank)

    def size(self) -> int:
        return math.prod(self.shape)

    def get_coordinate(self) -> Tuple[int, ...]:
        out, r = [], self.rank
        for n in reversed(self.shape):
            out.append(r % n)
            r //= n
        return tuple(reversed(out))

    def __repr__(self) -> str:
        return (f"ShapeMesh({dict(zip(self.mesh_dim_names, self.shape))}, "
                f"rank={self.rank})")


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
    shape-only mesh seen from rank 0.

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
    """{axis name: this rank's index} on a DeviceMesh or a ShapeMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def axis_group(mesh, axes):
    """The process group of this rank along ``axes`` (a name, or a tuple of
    names in mesh order), its ranks in row-major order of the mesh
    coordinate over ``axes``; on a ShapeMesh, the :class:`ShapeGroup` of
    that size and index.  A tuple's groups are created once per mesh:
    every rank creates every group of the partition, in one order, as
    ``torch.distributed.new_group`` requires."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = mesh.mesh_dim_names
    dims = [names.index(a) for a in axes]
    if dims != sorted(dims):
        raise ValueError(f"axes {axes} are not in mesh order {names}")
    if isinstance(mesh, ShapeMesh):
        sizes, coord, idx = axis_sizes(mesh), coordinate(mesh), 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
        return ShapeGroup(math.prod(sizes[a] for a in axes), idx)
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


def join_group(device: torch.device):
    """(rank, world size, the rank's device, the backend) under torchrun's
    variables: the process group joined, NCCL where the ranks on this host
    (``LOCAL_WORLD_SIZE``) have a card each, else gloo, whose collectives
    stage CUDA tensors through host memory (rank 0 says so); rank i takes
    ``cuda:(LOCAL_RANK % cards)``."""
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    backend = "gloo"
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                              % cards)
        torch.cuda.set_device(device)
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = "nccl" if local <= cards else "gloo"
        if rank == 0 and backend == "gloo":
            print(f"[group] gloo: {local} local ranks share {cards} cards; "
                  f"collectives stage through host memory", flush=True)
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank)
    return rank, world, device, backend
