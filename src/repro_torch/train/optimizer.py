"""AdamW + cosine schedule + global-norm clipping (the JAX package's
``train/optimizer.py``): plain functions on trees of tensors, the same f32
arithmetic in the same order, run under ``torch.no_grad``.

A tree is a nested dict (or tuple) of tensors; its leaves are taken in
``jax.tree_util``'s order (dict keys sorted), so the global norm sums the
leaves in the JAX package's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor       # int32 scalar: updates applied so far


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _rebuild(like, items):
    return type(like)(*items) if hasattr(like, "_fields") \
        else type(like)(items)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, *xs) for xs in zip(tree, *rest)])
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """``like``'s structure holding ``leaves`` (in :func:`tree_leaves`'s
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return _rebuild(t, [build(x) for x in t])
        return next(it)
    return build(like)


def init_opt_state(params: Any) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    step_dev = tree_leaves(params)[0].device
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=step_dev))


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio``."""
    warm = cfg.lr * torch.clamp((step + 1) / max(cfg.warmup_steps, 1),
                                max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(leaf.to(F32) ** 2)
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float, norm=None
                        ) -> Tuple[Any, torch.Tensor]:
    """``grads`` scaled to at most ``max_norm``; ``norm`` is their global
    norm (computed here unless given: sharded gradients bring theirs)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Any, grads: Any,
                 state: OptState, grad_norm=None
                 ) -> Tuple[Any, OptState, dict]:
    """One AdamW step on clipped gradients: (new params, new state,
    {"lr", "grad_norm"}).  New tensors throughout; nothing is updated in
    place.  ``grad_norm``: the gradients' global norm where they are a
    rank's shards (every update is elementwise, so a shard updates as its
    part of the whole)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, grad_norm)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(F32)
    b2c = 1 - cfg.b2 ** step.to(F32)

    def upd(p, g, m, v):
        g = g.to(F32)
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m2 / b1c
        vhat = v2 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay \
            * p.to(F32)
        return (p - lr * delta).to(p.dtype), m2, v2

    out = [upd(*x) for x in zip(*(tree_leaves(t) for t in (
        params, grads, state.m, state.v)))]
    pick = lambda j: tree_unflatten(params, [o[j] for o in out])
    return pick(0), OptState(pick(1), pick(2), step), {
        "lr": lr, "grad_norm": gnorm}
