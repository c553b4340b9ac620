"""train_step builder: loss -> gradients -> (int8 compression of the
cross-pod mean) -> AdamW, with optional microbatch gradient accumulation
(the JAX package's ``train/step.py``), on one card or on a device mesh.

The loss is differentiated with ``torch.autograd.grad`` over f32 master
parameters; the step is functional: it returns a new ``TrainState`` and
leaves the one it was given as it was.  Every registered architecture
trains, the moe family (the router's aux loss through the capacity
dispatch) and MLA included.

On a mesh (``launch/mesh.py``; ``mesh=``, ``dp=`` as the JAX step takes
them) every rank runs this code on its own process:

* the state's leaves are the rank's shards as ``models/sharding.py``'s
  ``param_specs`` lays them out: AdamW's m and v like their parameters,
  the step counter replicated (:func:`init_train_state`,
  :func:`shard_train_state`, :func:`gather_train_state`);
* the step takes the **global** batch and computes on the rank's shard of
  it over the ``dp`` axes; the loss is the mean over the global batch, the
  router's aux loss over the global batch too, and the step returns the
  JAX step's metrics (the same on every rank);
* the leaves are gathered (a differentiable all-gather, FSDP), a stacked
  layer's inside its remat unit as the layer runs, but the experts, which
  the moe layer keeps sharded over ``model`` and gathers over ``data``
  itself; every rank backpropagates its copy of the loss
  seeded with 1 / mesh size (``distributed/collectives.py``), so the
  gathers' reduce-scatters and a sum over each leaf's replica ranks give
  each shard its part of the gradient of the global loss, and work
  replicated over ``model`` is counted once;
* the global norm of the clipping sums each shard once.

``StepConfig.compress_pod_grads`` needs a mesh with a ``pod`` axis and
raises elsewhere (the JAX step skips it there).  The gradients are then
summed over every replica axis but ``pod``, so each pod holds its own
gradient, and ``distributed.compression.pod_compressed_mean`` takes their
mean over ``pod`` with int8 payloads.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression
from repro_torch.launch.mesh import axis_group, axis_sizes, coordinate
from repro_torch.models import sharding as shd
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.train import loss as loss_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32
STACKED = shd.STACKED


class TrainState(NamedTuple):
    params: Any
    opt: opt_mod.OptState


@dataclasses.dataclass(frozen=True)
class StepConfig:
    n_microbatches: int = 1
    aux_weight: float = 0.01
    compress_pod_grads: bool = False   # int8 compression on the pod axis


# ---------------------------------------------------------------------------
# State on one card or on a mesh
# ---------------------------------------------------------------------------
def state_specs(cfg: ModelConfig, mesh) -> TrainState:
    """The spec of every leaf of a ``TrainState`` on ``mesh``: parameters
    by ``param_specs``, m and v like them, the step replicated."""
    shapes = transformer.init_params(cfg, device="meta", masters=True)
    pspec = shd.param_specs(cfg, shapes, mesh)
    return TrainState(pspec, opt_mod.OptState(pspec, pspec, shd.P()))


def state_shardings(cfg: ModelConfig, mesh) -> TrainState:
    """``state_specs`` as ``NamedSharding``s (what ``restore_checkpoint``
    and ``save_checkpoint`` take)."""
    return shd.to_shardings(state_specs(cfg, mesh), mesh)


def shard_train_state(state: TrainState, cfg: ModelConfig,
                      mesh) -> TrainState:
    """This rank's shards of a whole ``state``."""
    return shd.map_specs(lambda spec, x: shd.shard(x, spec, mesh),
                         state_specs(cfg, mesh), state)


def gather_train_state(state: TrainState, cfg: ModelConfig,
                       mesh) -> TrainState:
    """The whole state from the ranks' shards (collective: every rank of
    the mesh calls it)."""
    return shd.map_specs(
        lambda spec, x: shd.gather(x, spec, mesh, differentiable=False),
        state_specs(cfg, mesh), state)


def init_train_state(cfg: ModelConfig, seed: int = 0, device=None,
                     mesh=None) -> TrainState:
    """f32 master parameters from ``transformer.init_params(seed)`` and
    zero AdamW moments, on ``device`` (``cuda`` unless named); on
    ``mesh``, this rank's shards of them, cut from each leaf (a stacked
    leaf one layer at a time) as it is drawn, so the whole state is never
    held."""
    keep = None if mesh is None else shd.shard_keeper(cfg, mesh)
    params = transformer.init_params(cfg, seed, device, masters=True,
                                     keep=keep)
    return TrainState(params=params, opt=opt_mod.init_opt_state(params))


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------
def make_loss_fn(cfg: ModelConfig, mesh=None, dp: tuple = ("data",),
                 aux_weight: float = 0.01) -> Callable:
    """loss_fn(params, batch, fetch=None) -> (loss, metrics); on
    ``mesh``, ``batch`` the rank's shard and the loss over the global
    batch, ``params`` whole but the experts (the rank's shards) and the
    stacked layers, which ``fetch(name, layer)`` gathers one layer at a
    time (``forward_train``)."""
    dp_group = None if mesh is None else axis_group(mesh, dp)

    def loss_fn(params, batch, fetch=None):
        hidden, aux = transformer.forward_train(cfg, params, batch,
                                                mesh=mesh, dp=dp,
                                                fetch=fetch)
        if cfg.frontend == "patch_embeds":
            # loss only on text positions (prefix = image patches)
            hidden = hidden[:, cfg.n_prefix:]
        return loss_mod.lm_loss(hidden, params["unembed"], batch["labels"],
                                cfg.vocab, cfg.logit_chunk, aux=aux,
                                aux_weight=aux_weight, dp_group=dp_group)
    return loss_fn


def _grads(loss, live, seed: float):
    """The gradient of every leaf of ``live`` (zeros for a leaf the loss
    does not reach, as ``jax.value_and_grad`` gives it), the backward
    seeded with ``seed``."""
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss, leaves, torch.full_like(loss, seed),
                                allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)`` on one card."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        grads = _grads(loss, live, 1.0)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def _spec_leaves(specs) -> list:
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    return [specs]


def dp_index(mesh, dp) -> Tuple[int, int]:
    """(this rank's row-major index over the ``dp`` axes, their size)."""
    sizes, coord = axis_sizes(mesh), coordinate(mesh)
    i = 0
    for a in dp:
        i = i * sizes[a] + coord[a]
    return i, math.prod(sizes[a] for a in dp)


def local_batch(batch: Dict[str, torch.Tensor], mesh, dp):
    """This rank's rows of the global batch, split over the ``dp`` axes."""
    i, n = dp_index(mesh, dp)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch {k} of {v.shape[0]} rows does not "
                             f"split over {dp} ({n} ranks)")
        b = v.shape[0] // n
        out[k] = v[i * b:(i + 1) * b]
    return out


class _MeshGrad:
    """The gradient of the global loss on a mesh, as a rank's shards."""

    def __init__(self, cfg, mesh, dp, aux_weight):
        self.mesh, self.dp = mesh, dp
        self.specs = state_specs(cfg, mesh).params
        self.loss_fn = make_loss_fn(cfg, mesh, dp, aux_weight)
        self.gather = shd.Gatherer(cfg, mesh)
        self.sizes = axis_sizes(mesh)

    def __call__(self, params, batch):
        """(loss, metrics, grads): the leaves gathered (a stacked layer's
        by ``Gatherer.fetch`` inside the layer's remat unit, so the
        backward gathers the layer again and no more than a layer's
        gathered leaves are alive at once)."""
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = self.loss_fn(
                self.gather.top(live), local_batch(batch, self.mesh, self.dp),
                self.gather.fetch)
            grads = _grads(loss, live, 1.0 / self.mesh.size())
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def reduce(self, grads, skip=()):
        """Each shard's gradient summed over the ranks that hold it (its
        replica axes, but those in ``skip``)."""
        out = []
        for g, spec in zip(grads, _spec_leaves(self.specs)):
            axes = tuple(a for a in shd.replica_axes(spec, self.mesh)
                         if a not in skip)
            out.append(coll.all_reduce_sum(g, axis_group(self.mesh, axes))
                       if axes else g)
        return out

    def global_norm(self, grads) -> torch.Tensor:
        """The norm of the whole gradient from the shards: each leaf's sum
        of squares over the mesh, divided by its replicas, then added in
        leaf order (as ``optimizer.global_norm`` adds)."""
        reps = [math.prod(self.sizes[a]
                          for a in shd.replica_axes(spec, self.mesh))
                for spec in _spec_leaves(self.specs)]
        ss = torch.stack([torch.sum(g.to(F32) ** 2) / r
                          for g, r in zip(grads, reps)])
        ss = coll.all_reduce_sum(
            ss, axis_group(self.mesh, self.mesh.mesh_dim_names))
        return torch.sqrt(sum(ss.unbind()))


def make_grad_fn(cfg: ModelConfig, step_cfg: StepConfig = StepConfig(),
                 mesh=None, dp: tuple = ("data",)) -> Callable:
    """grad_fn(params, batch) -> (loss, metrics, grads, grad norm or
    None): with ``n_microbatches`` > 1 the gradients summed in f32 over
    equal slices of the (global) batch and divided by their number, the
    metrics the last slice's; on a mesh the rank's shards of the gradient
    AdamW takes (after the pod mean where ``compress_pod_grads``) and
    their global norm."""
    if step_cfg.compress_pod_grads and (
            mesh is None or "pod" not in mesh.mesh_dim_names):
        raise ValueError("compress_pod_grads needs a mesh with a 'pod' "
                         "axis (the JAX step skips it without one)")
    if mesh is None:
        loss_fn = make_loss_fn(cfg, aux_weight=step_cfg.aux_weight)
        vg = lambda params, batch: value_and_grad(loss_fn, params, batch)
    else:
        mg = _MeshGrad(cfg, mesh, dp, step_cfg.aux_weight)
        vg = mg

    def grad_fn(params, batch):
        n = step_cfg.n_microbatches
        if n <= 1:
            loss, metrics, grads = vg(params, batch)
        else:
            acc = None
            loss = 0.0
            for i in range(n):
                mb = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
                      for k, x in batch.items()}
                l_i, metrics, g = vg(params, mb)
                g = [x.to(F32) for x in tree_leaves(g)]
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
                loss = loss + l_i
            loss, grads = loss / n, [a / n for a in acc]
            if mesh is None:
                grads = tree_unflatten(params, grads)
        if mesh is None:
            return loss, metrics, grads, None
        if step_cfg.compress_pod_grads:
            n_pod = axis_sizes(mesh)["pod"]
            grads = [g * n_pod for g in mg.reduce(grads, skip=("pod",))]
            grads = compression.pod_compressed_mean(grads, mesh)
        else:
            grads = mg.reduce(grads)
        return (loss, metrics, tree_unflatten(params, grads),
                mg.global_norm(grads))

    return grad_fn


def make_train_step(cfg: ModelConfig, opt_cfg: opt_mod.OptimizerConfig,
                    step_cfg: StepConfig = StepConfig(), mesh=None,
                    dp: tuple = ("data",)) -> Callable:
    """train_step(state, batch) -> (new state, metrics): the loss and its
    gradients (``make_grad_fn``), then ``adamw_update``."""
    grad_fn = make_grad_fn(cfg, step_cfg, mesh, dp)

    def train_step(state: TrainState, batch: Dict[str, Any]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        loss, metrics, grads, norm = grad_fn(state.params, batch)
        params, opt, opt_metrics = opt_mod.adamw_update(
            opt_cfg, state.params, grads, state.opt, grad_norm=norm)
        return TrainState(params, opt), dict(metrics, loss=loss,
                                             **opt_metrics)

    return train_step
