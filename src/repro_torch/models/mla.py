"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The PyTorch counterpart of the JAX package's ``models/mla.py``.  KV
activations are compressed into a rank-``kv_lora_rank`` latent ``c_kv``
plus one shared RoPE key ``k_rope``; the decode cache stores only
``(c_kv [B,T,R], k_rope [B,T,dr])``.  Queries come from their own
low-rank path.

* prefill — decompress c_kv to per-head K/V and run standard MHA through
  ``layers.attention_ref`` (q/k head dim ``qk_nope + qk_rope``, v head dim
  ``v_head_dim``);
* decode — the *absorbed* form: W_uk folded into the query and W_uv into
  the output, so attention runs over the latent cache itself.

The flash-attention kernel has no form for a q/k head dim that differs
from v's (nor has the TPU kernel it replaces, on which the JAX package's
MLA prefill with ``attn_impl='pallas'`` fails), so MLA runs the reference
attention only: :func:`check_impl` refuses ``'kernel'``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import (BF16, F32, NEG_INF, apply_rope,
                                       attention_ref, init_dense,
                                       rope_angles)


def check_impl(cfg) -> None:
    """Raise ``ValueError`` for MLA with ``attn_impl='kernel'``."""
    if cfg.attn_impl == "kernel":
        raise ValueError(
            f"{cfg.name}: MLA has no flash-attention kernel (q/k head dim "
            f"{cfg.qk_nope_dim + cfg.qk_rope_dim} != v head dim "
            f"{cfg.v_head_dim}; the TPU kernel has no such form and the "
            f"JAX package's MLA prefill with 'pallas' fails on it); serve "
            f"it with attn_impl='ref'")


def init_mla(gen, cfg, device=None):
    H = cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    dense = lambda d_in, d_out: init_dense(gen, d_in, d_out, device=device)
    return {
        "w_dq": dense(cfg.d_model, cfg.q_lora_rank),
        "w_uq": dense(cfg.q_lora_rank, H * qk),
        "w_dkv": dense(cfg.d_model, cfg.kv_lora_rank + cfg.qk_rope_dim),
        "w_uk": dense(cfg.kv_lora_rank, H * cfg.qk_nope_dim),
        "w_uv": dense(cfg.kv_lora_rank, H * cfg.v_head_dim),
        "wo": dense(H * cfg.v_head_dim, cfg.d_model),
    }


def _queries(params, x, cfg, positions):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = (x.to(BF16) @ params["w_dq"].to(BF16)) @ params["w_uq"].to(BF16)
    q = q.reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_angles(positions, dr, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _latent(params, x, cfg, positions):
    """c_kv [B,S,R] and the rope'd shared key k_rope [B,S,dr]."""
    R, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    ckr = x.to(BF16) @ params["w_dkv"].to(BF16)
    c_kv, k_rope = ckr[..., :R], ckr[..., R:]
    cos, sin = rope_angles(positions, dr, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return c_kv, k_rope


def mla_prefill(params, x, cfg, positions):
    """Standard (decompressed) MHA over the latent KV.  Returns (out
    [B,S,d] in x.dtype, the latent cache (c_kv, k_rope))."""
    check_impl(cfg)
    B, S, _ = x.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _queries(params, x, cfg, positions)
    c_kv, k_rope = _latent(params, x, cfg, positions)

    k_nope = (c_kv @ params["w_uk"].to(BF16)).reshape(B, S, H, dn)
    v = (c_kv @ params["w_uv"].to(BF16)).reshape(B, S, H, dv)
    # the shared rope key broadcast to every head: one attention call
    k_rope_h = k_rope[:, :, None, :].expand(B, S, H, dr)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    out = attention_ref(q, k, v, causal=True, scale=1.0 / math.sqrt(dn + dr))
    out = out.reshape(B, S, H * dv).to(BF16)
    return (out @ params["wo"].to(BF16)).to(x.dtype), (c_kv, k_rope)


def mla_decode(params, x, cfg, positions, cache, cache_len: int):
    """Absorbed-matrix decode over the latent cache (c_kv [B,T,R], k_rope
    [B,T,dr]), ``cache_len`` valid entries: the new entries are written in
    place (as ``layers.attn_block`` does); scores are
    q_nope W_uk^T c_kv + q_rope k_rope and the values the latent itself,
    expanded through W_uv after the weighted sum.  Returns (out, cache)."""
    B, S, _ = x.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    R = cfg.kv_lora_rank

    q_nope, q_rope = _queries(params, x, cfg, positions)
    c_new, kr_new = _latent(params, x, cfg, positions)
    c_cache, kr_cache = cache
    c_cache[:, cache_len:cache_len + S] = c_new.to(c_cache.dtype)
    kr_cache[:, cache_len:cache_len + S] = kr_new.to(kr_cache.dtype)

    # absorb W_uk into q: q_lat [B,S,H,R]
    w_uk = params["w_uk"].to(BF16).reshape(R, H, dn)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)

    # f32 scores of bf16 operands (the JAX code's preferred_element_type)
    scale = 1.0 / math.sqrt(dn + dr)
    logits = (torch.einsum("bshr,btr->bhst", q_lat.to(F32),
                           c_cache.to(BF16).to(F32))
              + torch.einsum("bshd,btd->bhst", q_rope.to(F32),
                             kr_cache.to(BF16).to(F32))) * scale
    T = c_cache.shape[1]
    valid = torch.arange(T, device=x.device) < cache_len + S
    logits = logits.masked_fill(~valid, NEG_INF)
    att = torch.softmax(logits, dim=-1)

    # the weighted latent sum, then expanded through W_uv
    o_lat = torch.einsum("bhst,btr->bshr", att.to(BF16),
                         c_cache.to(BF16))                      # [B,S,H,R]
    w_uv = params["w_uv"].to(BF16).reshape(R, H, dv)
    out = torch.einsum("bshr,rhd->bshd", o_lat, w_uv).reshape(B, S, H * dv)
    return (out @ params["wo"].to(BF16)).to(x.dtype), (c_cache, kr_cache)
