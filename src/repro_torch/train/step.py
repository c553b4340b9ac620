"""train_step builder: loss -> gradients -> AdamW, with optional
microbatch gradient accumulation (the JAX package's ``train/step.py`` on
one card).

The loss is differentiated with ``torch.autograd.grad`` over f32 master
parameters; the step is functional: it returns a new ``TrainState`` and
leaves the one it was given as it was.  The JAX step's int8
error-feedback compression on a mesh's ``pod`` axis
(``StepConfig.compress_pod_grads``) needs a mesh, which the port does not
have yet: asking for it raises.  The moe family and MLA are not held
against the JAX package in training yet: ``check_trainable`` refuses
them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.train import loss as loss_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


class TrainState(NamedTuple):
    params: Any
    opt: opt_mod.OptState


@dataclasses.dataclass(frozen=True)
class StepConfig:
    n_microbatches: int = 1
    aux_weight: float = 0.01
    compress_pod_grads: bool = False   # int8 error-feedback on the pod axis


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for an architecture the port does not train
    yet: the moe family (the aux loss's gradient through the capacity
    dispatch) and MLA."""
    if cfg.family == "moe" or cfg.use_mla:
        raise ValueError(
            f"{cfg.name}: training the moe family and MLA is not ported "
            f"yet (the router's aux-loss gradient through the capacity "
            f"dispatch is not held against the JAX package)")


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     device=None) -> TrainState:
    """f32 master parameters from ``transformer.init_params(seed)`` and
    zero AdamW moments, on ``device`` (``cuda`` unless named)."""
    check_trainable(cfg)
    params = transformer.init_params(cfg, seed, device, masters=True)
    return TrainState(params=params, opt=opt_mod.init_opt_state(params))


def make_loss_fn(cfg: ModelConfig, aux_weight: float = 0.01) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics)."""
    def loss_fn(params, batch):
        hidden, aux = transformer.forward_train(cfg, params, batch)
        if cfg.frontend == "patch_embeds":
            # loss only on text positions (prefix = image patches)
            hidden = hidden[:, cfg.n_prefix:]
        return loss_mod.lm_loss(hidden, params["unembed"], batch["labels"],
                                cfg.vocab, cfg.logit_chunk, aux=aux,
                                aux_weight=aux_weight)
    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)``: the gradient
    of every leaf, zeros for a leaf the loss does not reach (musicgen's
    token embedding), as ``jax.value_and_grad`` gives it."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: opt_mod.OptimizerConfig,
                    step_cfg: StepConfig = StepConfig()) -> Callable:
    """train_step(state, batch) -> (new state, metrics): the loss and its
    gradients (with ``n_microbatches`` > 1, summed in f32 over equal
    slices of the batch and divided by their number, the metrics the last
    slice's), then ``adamw_update``."""
    check_trainable(cfg)
    if step_cfg.compress_pod_grads:
        raise ValueError("compress_pod_grads needs a mesh with a 'pod' "
                         "axis; the port trains on one card")
    loss_fn = make_loss_fn(cfg, aux_weight=step_cfg.aux_weight)

    def compute_grads(params, batch):
        n = step_cfg.n_microbatches
        if n <= 1:
            return value_and_grad(loss_fn, params, batch)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                             device=p.device), params)
        loss_sum = torch.zeros((), dtype=F32, device=batch["labels"].device)
        for i in range(n):
            mb = {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
                  for k, x in batch.items()}
            loss, metrics, grads = value_and_grad(loss_fn, params, mb)
            acc = tree_map(lambda a, g: a + g.to(F32), acc, grads)
            loss_sum = loss_sum + loss
        return loss_sum / n, metrics, tree_map(lambda a: a / n, acc)

    def train_step(state: TrainState, batch: Dict[str, Any]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        loss, metrics, grads = compute_grads(state.params, batch)
        params, opt, opt_metrics = opt_mod.adamw_update(
            opt_cfg, state.params, grads, state.opt)
        return TrainState(params, opt), dict(metrics, loss=loss,
                                             **opt_metrics)

    return train_step
