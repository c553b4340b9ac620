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
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(x: torch.Tensor, group) -> bool:
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_comm(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``x`` where the group's backend can take it."""
    x = x.detach()
    return (x.to("cpu") if _staged(x, group) else x.clone()).contiguous()


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group`` (a new tensor; no autograd)."""
    if group is None or size(group) == 1:
        return x.detach().clone()
    buf = _to_comm(x, group)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order
    (no autograd)."""
    n = size(group)
    if n == 1:
        return x.detach().clone()
    src = _to_comm(x, group)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(x.device)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of ``x`` (along dim 0, equal chunks) to group rank i; chunk
    i of the result came from group rank i (no autograd)."""
    if size(group) == 1:
        return x.detach().clone()
    src = _to_comm(x, group)
    out = torch.empty_like(src)
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
        ctx.me = 0 if size(group) == 1 else dist.get_rank(group)
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
