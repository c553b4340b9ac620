"""Parameter trees from the JAX package into the port.

``params_from_jax`` takes the JAX model's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``; no JAX import here) and returns the
port's tree: the same nested dict under the same names, with stacked
[L, ...] layer leaves (deepseek's leading dense layers under
``first_blocks``, as there).  The leaves the JAX code casts to bf16 at
every use (``embed``, ``unembed``, ``wq/wk/wv/wo``, the QKV biases,
``w_gate/w_up/w_down`` of the MLPs and the experts, ``in_proj``,
``out_proj``, the MoE ``router`` and MLA's ``w_dq/w_uq/w_dkv/w_uk/w_uv``;
``transformer.BF16_LEAVES``) are stored in bf16 once, which is exact
because the cast is the same rounding; every other leaf (norm weights,
``conv_w``/``conv_b``, ``A_log``, ``D``, ``dt_bias``) stays f32.  With
``masters=True`` every leaf stays f32, as training needs.

``train_state_from_jax`` carries a whole JAX ``TrainState`` (parameters,
AdamW's m and v, the step) across, so that both packages can train from
one state: every family's, the moe family's experts and router and
MLA's low-rank projections included (on a mesh, ``train.step.
shard_train_state`` then cuts the rank's shards, and a JAX checkpoint
restores straight into a sharded state through
``distributed.checkpoint.restore_checkpoint(..., shardings=)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (cast_bf16_leaves,
                                            check_supported, map_leaves)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: exact via f32
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree, cfg: ModelConfig, device=None,
                    masters: bool = False):
    """The port's parameter tree for ``cfg`` from JAX's ``tree`` (nested
    dicts of numpy arrays): the ``BF16_LEAVES`` in bf16, or every leaf in
    f32 with ``masters`` (the f32 masters AdamW updates)."""
    check_supported(cfg)
    device = resolve_device(device)
    params = map_leaves(lambda a: _tensor(a, device), tree)
    return params if masters else cast_bf16_leaves(params)


def train_state_from_jax(state, cfg: ModelConfig, device=None):
    """The port's ``TrainState`` from a JAX ``TrainState`` of numpy arrays
    (``jax.tree.map(np.asarray, state)``; read by its fields ``params``
    and ``opt.m``, ``opt.v``, ``opt.step``): f32 master parameters, m and
    v in f32 and the int32 step, leaf for leaf."""
    from repro_torch.train.optimizer import OptState
    from repro_torch.train.step import TrainState
    device = resolve_device(device)
    to = lambda tree: map_leaves(lambda a: _tensor(a, device), tree)
    opt = state.opt
    return TrainState(
        params=params_from_jax(state.params, cfg, device, masters=True),
        opt=OptState(m=to(opt.m), v=to(opt.v),
                     step=torch.tensor(int(np.asarray(opt.step)),
                                       dtype=torch.int32, device=device)))
