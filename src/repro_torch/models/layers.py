"""Shared model building blocks: RMSNorm, RoPE, GQA attention, SwiGLU MLP.

The PyTorch counterpart of the JAX package's ``models/layers.py``, with
the same names, argument order and layouts ([B, S, H, D]).  Parameters are
plain dicts of tensors.  Matmul inputs are bf16 while reductions (softmax,
norms) run in f32, as there.  Where the JAX code contracts bf16 operands
with ``preferred_element_type=F32`` (an f32 result), the port upcasts the
bf16 operands and contracts in f32: the products are exact, only the
summation order differs.  ``x @ W`` with both operands bf16 is bf16 in both
packages.  Attention has two implementations selected by ``impl``:
``"ref"`` (the einsum reference) and ``"kernel"`` (the flash-attention
kernel in ``repro_torch/kernels``, through ``FlashAttentionFn``, whose
backward recomputes the kernel's plain version).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.config import IMPLS

BF16 = torch.bfloat16
F32 = torch.float32
NEG_INF = -1e30


def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None, device=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=gen, dtype=F32,
                       device=device) * scale


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_angles(positions: torch.Tensor, dim: int,
                theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` [**shape**] -> [..., dim//2]."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=F32,
                                        device=positions.device) / dim))
    ang = positions.to(F32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., S, H, D]; cos/sin [S, D/2].  The bf16 x times the f32 tables
    is f32; the result is cast back to ``x.dtype``."""
    d_half = x.shape[-1] // 2
    x1, x2 = x[..., :d_half], x[..., d_half:]
    c = cos[..., None, :]                                   # [S, 1, D/2]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA / MHA via n_kv_heads)
# ---------------------------------------------------------------------------
def attention_ref(q, k, v, causal: bool = True, q_offset: int = 0,
                  kv_valid_len: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention.  q [B,Sq,Hq,Dk], k [B,Skv,Hkv,Dk], v [B,Skv,
    Hkv,Dv] -> f32 [B,Sq,Hq,Dv].  The dots take bf16-rounded operands with
    f32 results, as the JAX reference's ``preferred_element_type=F32``.

    * ``q_offset``: absolute position of q[0] (decode: cache length).
    * ``kv_valid_len``: mask out cache slots >= this length.
    """
    B, Sq, Hq, Dk = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dk)

    qg = q.reshape(B, Sq, Hkv, G, Dk).to(BF16).to(F32)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                          k.to(BF16).to(F32)) * scale

    kv_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if kv_valid_len is not None:
        mask &= kv_pos[None, :] < kv_valid_len
    logits = logits.masked_fill(~mask, NEG_INF)

    att = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", att.to(BF16).to(F32),
                       v.to(BF16).to(F32))
    return out.reshape(B, Sq, Hq, v.shape[-1])


def attention(q, k, v, *, impl: str = "ref", causal: bool = True,
              q_offset=0, kv_valid_len=None, scale=None):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel" and q.shape[1] > 1 and kv_valid_len is None:
        from repro_torch.kernels.flash_attention import FlashAttentionFn
        return FlashAttentionFn.apply(q, k, v, causal, scale)
    return attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                         kv_valid_len=kv_valid_len, scale=scale)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def init_mlp(gen, d_model: int, d_ff: int, device=None):
    return {
        "w_gate": init_dense(gen, d_model, d_ff, device=device),
        "w_up": init_dense(gen, d_model, d_ff, device=device),
        "w_down": init_dense(gen, d_ff, d_model, device=device),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    xb = x.to(BF16)
    g = xb @ params["w_gate"].to(BF16)
    u = xb @ params["w_up"].to(BF16)
    h = torch.nn.functional.silu(g.to(F32)).to(BF16) * u
    return (h @ params["w_down"].to(BF16)).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (params + forward, cache-aware)
# ---------------------------------------------------------------------------
def init_attn(gen, d_model: int, n_heads: int, n_kv_heads: int, d_head: int,
              qkv_bias: bool = False, device=None):
    p = {
        "wq": init_dense(gen, d_model, n_heads * d_head, device=device),
        "wk": init_dense(gen, d_model, n_kv_heads * d_head, device=device),
        "wv": init_dense(gen, d_model, n_kv_heads * d_head, device=device),
        "wo": init_dense(gen, n_heads * d_head, d_model, device=device),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * d_head,), dtype=F32, device=device)
        p["bk"] = torch.zeros((n_kv_heads * d_head,), dtype=F32,
                              device=device)
        p["bv"] = torch.zeros((n_kv_heads * d_head,), dtype=F32,
                              device=device)
    return p


def attn_qkv(params, x, n_heads, n_kv_heads, d_head):
    B, S, _ = x.shape
    xb = x.to(BF16)
    q = xb @ params["wq"].to(BF16)
    k = xb @ params["wk"].to(BF16)
    v = xb @ params["wv"].to(BF16)
    if "bq" in params:
        q = q + params["bq"].to(BF16)
        k = k + params["bk"].to(BF16)
        v = v + params["bv"].to(BF16)
    return (q.reshape(B, S, n_heads, d_head),
            k.reshape(B, S, n_kv_heads, d_head),
            v.reshape(B, S, n_kv_heads, d_head))


def attn_block(params, x, *, n_heads, n_kv_heads, d_head, rope_theta,
               positions, impl="ref", cache_kv=None, cache_len=None):
    """Full GQA attention with RoPE.

    * train/prefill: ``cache_kv`` None -> causal self-attention over x;
      returns (out, (k, v)) so prefill can persist the cache.
    * decode: ``cache_kv`` = (k_cache [B,T,Hkv,D], v_cache) with
      ``cache_len`` (an int) valid entries; x is the new token(s).  The new
      k/v are written into the caches in place (the JAX code returns
      updated copies; in place saves copying the whole cache every step);
      returns (out, (k_cache, v_cache)).
    """
    B, S, _ = x.shape
    q, k, v = attn_qkv(params, x, n_heads, n_kv_heads, d_head)
    cos, sin = rope_angles(positions, d_head, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache_kv is None:
        out = attention(q, k, v, impl=impl, causal=True)
        new_cache = (k.to(BF16), v.to(BF16))
    else:
        k_cache, v_cache = cache_kv
        k_cache[:, cache_len:cache_len + S] = k.to(k_cache.dtype)
        v_cache[:, cache_len:cache_len + S] = v.to(v_cache.dtype)
        out = attention(q, k_cache, v_cache, impl=impl, causal=False,
                        kv_valid_len=cache_len + S)
        new_cache = (k_cache, v_cache)

    out = out.reshape(B, S, n_heads * d_head).to(BF16)
    return (out @ params["wo"].to(BF16)).to(x.dtype), new_cache
