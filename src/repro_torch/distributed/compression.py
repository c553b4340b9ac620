"""int8 gradient compression for the cross-pod mean, with error feedback
(the JAX package's ``distributed/compression.py``).

Intra-pod reduction stays full precision; the pod axis is the slow link,
where a 4x byte reduction matters.  Error feedback keeps the quantization
residual locally and adds it to the next step's gradient, so the
compressed trajectory tracks the exact one (Karimireddy et al.).

Per-tensor absmax int8: ``torch.round`` rounds half to even, as
``jnp.round`` does, so ``quantize_int8`` and ``ErrorFeedback.apply`` are
the JAX package's bit for bit.  ``compressed_psum_mean`` reduces over a
``torch.distributed`` group (the mesh's ``pod`` sub-group in
:func:`pod_compressed_mean`), summing the dequantized f32 payloads as the
JAX ``psum`` does.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.launch.mesh import axis_group
from repro_torch.train.optimizer import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8.  Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compressed_psum_mean(x: torch.Tensor, group) -> torch.Tensor:
    """int8-compressed mean of ``x`` over ``group``: each member's
    quantized payload, dequantized, summed in f32 and divided by the
    group's size."""
    q, scale = quantize_int8(x)
    total = coll.all_reduce_sum(q.to(torch.int32).to(F32) * scale, group)
    return total / coll.size(group)


def pod_compressed_mean(grads: Any, mesh) -> Any:
    """Mean gradients across the mesh's ``pod`` axis with int8 payloads.

    Each pod's gradients arrive reduced within the pod (the train step
    sums them over the other replica axes); this is the cross-pod mean.
    Leaves keep their (data/model) shards — only 'pod' is reduced.  On a
    mesh without a ``pod`` axis the gradients come back unchanged, as in
    the JAX package (the train step refuses ``compress_pod_grads`` there
    instead)."""
    if "pod" not in mesh.mesh_dim_names:
        return grads
    group = axis_group(mesh, "pod")
    return tree_map(lambda g: compressed_psum_mean(g, group), grads)


class ErrorFeedback:
    """Residual-carrying wrapper: grads' = Q(grads + residual);
    residual' = (grads + residual) - grads'."""

    @staticmethod
    def init(grads_like: Any) -> Any:
        return tree_map(lambda g: torch.zeros(g.shape, dtype=F32,
                                              device=g.device), grads_like)

    @staticmethod
    def apply(grads: Any, residual: Any) -> Tuple[Any, Any]:
        def leaf(g, r):
            corrected = g.to(F32) + r
            q, scale = quantize_int8(corrected)
            deq = dequantize_int8(q, scale)
            return deq.to(g.dtype), corrected - deq

        pairs = [leaf(g, r) for g, r in zip(tree_leaves(grads),
                                            tree_leaves(residual))]
        return (tree_unflatten(grads, [p[0] for p in pairs]),
                tree_unflatten(residual, [p[1] for p in pairs]))
