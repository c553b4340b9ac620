"""Collectives over a mesh axis group, plain and differentiable.

The mesh path of the train step (``train/step.py``) and the moe layer's
expert-parallel bodies (``models/moe.py``) are one program on every rank:
each rank backpropagates its copy of the (replicated) global loss seeded
with 1 / mesh size, so that the cotangents of every rank together make the
gradient of the loss.  The adjoints below hold under that convention (the
transposes JAX's ``shard_map`` takes):

* ``all_reduce_sum`` (psum)      — backward: all-reduce the cotangents;
* ``all_gather`` along a dim     — backward: all-reduce, then this rank's
  chunk (a reduce-scatter);
* ``all_to_all`` of equal chunks — backward: the same exchange of the
  cotangents.

A parameter held by several ranks (a replica) then has its gradient summed
over them (``train/step.py``).  Under gloo a CUDA tensor stages through
host memory: it is copied to the host, reduced there and copied back (NCCL
takes it in place).  Every collective here stages the same way, so a gloo
group may hold ranks that share one card.  There is no quiet fallback: a
collective on a group of more than one rank needs that group.

A shape-only group (:class:`ShapeGroup`, a ``launch.mesh.ShapeMesh``'s) takes
``meta`` tensors only, and raises on any other: the collective makes its
local copies as on a real group and returns an output of the right shape
and type, communicating nothing.  Every collective of more than one rank,
on a real group or a shape-only one, hands ``(op, bytes, group size)`` to
each open :func:`recording` (op as the HLO names it: ``all-reduce`` with
the buffer's bytes, ``all-gather`` with the result's, ``all-to-all`` with
the buffer's), so a shape-only trace can be held to a real rank's.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

_RECORDINGS: list = []


@dataclasses.dataclass(frozen=True)
class ShapeGroup:
    """A ShapeMesh's group along some axes: its size and this rank's index
    in it (row-major over the axes), with no process group behind it.
    The collectives take it on ``meta`` tensors only."""
    size: int
    rank: int


@contextlib.contextmanager
def recording():
    """Yields a list that receives ``(op, bytes, group size)`` for every
    collective of more than one rank called in the block, in call order."""
    recs: list = []
    _RECORDINGS.append(recs)
    try:
        yield recs
    finally:
        _RECORDINGS.remove(recs)


def _record(op: str, t: torch.Tensor, n: int) -> None:
    for recs in _RECORDINGS:
        recs.append((op, t.numel() * t.element_size(), n))


def _shape_only(x: torch.Tensor, group) -> bool:
    """Whether ``group`` is shape-only; raises if it is and ``x`` is not
    on ``meta``."""
    if not isinstance(group, ShapeGroup):
        return False
    if x.device.type != "meta":
        raise ValueError(f"a shape-only group takes meta tensors, got one "
                         f"on {x.device}")
    return True


def _staged(x: torch.Tensor, group) -> bool:
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_comm(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``x`` where the group's backend can take it."""
    x = x.detach()
    return (x.to("cpu") if _staged(x, group) else x.clone()).contiguous()


def size(group) -> int:
    if group is None:
        return 1
    if isinstance(group, ShapeGroup):
        return group.size
    return dist.get_world_size(group)


def rank_in(group) -> int:
    """This rank's index in ``group``."""
    if isinstance(group, ShapeGroup):
        return group.rank
    return 0 if size(group) == 1 else dist.get_rank(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` (a new tensor; no autograd)."""
    n = size(group)
    if n == 1:
        return x.detach().clone()
    shape_only = _shape_only(x, group)
    buf = _to_comm(x, group)
    _record("all-reduce", buf, n)
    if not shape_only:
        dist.all_reduce(buf, group=group)
    return buf.to(x.device)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order
    (no autograd)."""
    n = size(group)
    if n == 1:
        return x.detach().clone()
    shape_only = _shape_only(x, group)
    src = _to_comm(x, group)
    parts = [torch.empty_like(src) for _ in range(n)]
    if not shape_only:
        dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    _record("all-gather", out, n)
    return out.to(x.device)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of ``x`` (along dim 0, equal chunks) to group rank i; chunk
    i of the result came from group rank i (no autograd)."""
    n = size(group)
    if n == 1:
        return x.detach().clone()
    shape_only = _shape_only(x, group)
    src = _to_comm(x, group)
    out = torch.empty_like(src)
    _record("all-to-all", src, n)
    if not shape_only:
        dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


class AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        ctx.me = rank_in(group)
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum(g, ctx.group)
        return g.narrow(ctx.dim, ctx.me * ctx.n, ctx.n).contiguous(), \
            None, None


class AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group`` (identity on one rank)."""
    return x if size(group) == 1 else AllReduceSum.apply(x, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Differentiable all-gather along ``dim`` (identity on one rank)."""
    return x if size(group) == 1 else AllGather.apply(x, dim, group)


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-to-all of ``x``'s dim-0 chunks (identity on one
    rank)."""
    return x if size(group) == 1 else AllToAll.apply(x, group)
