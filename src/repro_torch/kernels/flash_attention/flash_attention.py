"""Causal flash attention (forward): wrapper and plain version.

The wrapper launches ``csrc/flash_attention.cu`` (see the note at the top
of that file) on CUDA tensors and runs the plain version,
:func:`flash_attention_ref`, on CPU tensors.  Contract against the plain
version: rtol/atol 1e-5 on f32 inputs (exp and summation order); on bf16
inputs, every output element within ``BF16_ULPS`` bf16 ulps of the plain
version's element plus ``BF16_ATOL`` (:func:`bf16_limit_share`).  Both
round one f32 result to bf16, so they land at most one ulp apart where
their f32 values (within the f32 contract) straddle a rounding boundary;
the second ulp is margin, and the atol covers elements near zero, whose
ulp is finer than f32's summation error.  A variant that rounds p or the
PV accumulator to bf16 misses this limit by 30-130x on the tests' shapes.

The kernel computes the forward only, and the raw wrapper refuses an
input that requires grad (``kernels.check_no_grad``).  The model trains
through :class:`FlashAttentionFn`, whose backward recomputes the plain
version, as the JAX package's ``custom_vjp`` op does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import (LAUNCHES, check_cuda_tensor, check_no_grad,
                                 meta_stand_in)

HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's template instances
WGMMA_HEAD_DIMS = (64, 128)     # the tensor-core variant's, on bf16
CUDA_LAUNCHES_PER_CALL = 1
NEG_INF = -1e30
BF16_ULPS = 2
BF16_ATOL = 1e-5


def bf16_limit_share(got, ref, ulps: float = BF16_ULPS,
                     atol: float = BF16_ATOL) -> float:
    """Largest |got - ref| as a share of its element's limit, ``ulps``
    bf16 ulps of |ref| (8 significant bits) plus ``atol``: at most 1 when
    every element is within the limit."""
    got, ref = got.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    return ((got - ref).abs() / (ulps * ulp + atol)).max().item()


def flash_attention_ref(q, k, v, causal: bool = True, scale=None):
    """The plain version: f32 scores, softmax and PV product on the inputs
    upcast, output in ``q.dtype``.  q [B,Sq,Hq,D], k/v [B,Skv,Hkv,D]."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if causal:
        mask = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril(Skv - Sq)
        logits = logits.masked_fill(~mask, NEG_INF)
    att = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", att, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def variant(dtype, D: int) -> str:
    """The kernel variant a CUDA call runs, by input type and head dim
    alone: ``'wgmma'`` (TMA ring, bf16 tensor cores, p split into two bf16
    parts) for bf16 with D in ``WGMMA_HEAD_DIMS``, else ``'fp32'`` (the
    FP32-pipe kernel: f32 inputs, and D 16, 32 or 256)."""
    return "wgmma" if (dtype == torch.bfloat16
                       and D in WGMMA_HEAD_DIMS) else "fp32"


def _lib():
    from repro_torch.kernels import _build
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, causal: bool = True, scale=None):
    """Attention of q [B,S,Hq,D] over k/v [B,S,Hkv,D] (self-attention:
    Sq = Skv), output [B,S,Hq,D] in ``q.dtype``.  CPU tensors run
    :func:`flash_attention_ref`; CUDA tensors launch the kernel on the
    current stream (bf16 or f32, D in ``HEAD_DIMS``, contiguous): the
    variant :func:`variant` names for the type and D, one CUDA launch."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, scale)
    check_no_grad("flash_attention", q=q, k=k, v=v)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention takes bf16 or f32, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention head dim must be one of "
                         f"{HEAD_DIMS}, got {D}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q heads {Hq} must be a multiple of kv heads {Hkv}")
    if q.device.type == "meta":
        return meta_stand_in("flash_attention", flash_attention_ref, q, k, v,
                             causal, scale)
    check_cuda_tensor("q", q, q.dtype, (B, S, Hq, D))
    check_cuda_tensor("k", k, q.dtype, (B, S, Hkv, D))
    check_cuda_tensor("v", v, q.dtype, (B, S, Hkv, D))
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, S, Hq, Hkv, D, int(causal), scale,
                 int(q.dtype == torch.bfloat16),
                 int(variant(q.dtype, D) == "wgmma"),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return o


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with a backward, the counterpart of the JAX
    package's ``custom_vjp`` op (``repro/kernels/flash_attention/ops.py``):
    the forward is the wrapper (the kernel on CUDA tensors, the plain
    version on CPU ones); the backward recomputes
    :func:`flash_attention_ref` from the saved q, k, v and returns its
    VJP, so the gradients are the plain version's autograd bit for bit.
    ``FlashAttentionFn.apply(q, k, v, causal, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, scale=None):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return flash_attention(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = flash_attention_ref(*ins, ctx.causal, ctx.scale)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None, None)
