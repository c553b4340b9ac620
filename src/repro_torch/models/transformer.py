"""Decoder assembly for the dense, ssm and hybrid families.

The PyTorch counterpart of the JAX package's ``models/transformer.py``:
one parameter tree and the entry points

* ``forward_train`` — full causal forward, returns (hidden, aux_loss)
  (forward only here: the tests compare it, no trainer runs it yet);
* ``prefill``       — forward that also returns the per-layer cache;
* ``decode_step``   — one-token step against the cache.

Layer parameters are stacked ([L, ...] leaves, under the JAX names) and a
Python loop walks the layers where the JAX code scans them.  The port runs
on one card: no mesh, sharding or remat.  The moe family, MLA and the
patch/frame-embedding frontends wait for a later slice (ROADMAP Queue 1
item 12) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.types import resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    BF16, F32, attn_block, init_attn, init_mlp, mlp, rmsnorm,
)

Params = Dict[str, Any]

# leaves the JAX code casts to bf16 at every use: stored in bf16 once
BF16_LEAVES = frozenset({"embed", "unembed", "wq", "wk", "wv", "wo", "bq",
                         "bk", "bv", "w_gate", "w_up", "w_down", "in_proj",
                         "out_proj"})
_LATER = ("not in this slice of the port (ROADMAP Queue 1 item 12: moe, "
          "MLA and the patch/frame-embedding frontends come later)")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    if cfg.family == "moe" or cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: the moe family is {_LATER}")
    if cfg.use_mla:
        raise NotImplementedError(f"{cfg.name}: MLA is {_LATER}")
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is {_LATER}")


def map_leaves(fn, tree):
    """``fn`` applied to every tensor of a nested dict/tuple tree."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map_leaves(fn, v) for v in tree)
    return fn(tree)


def _layer(tree, i: int):
    return map_leaves(lambda a: a[i], tree)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([t[j] for t in trees]) for j in range(len(first)))
    return torch.stack(trees)


def cast_bf16_leaves(tree):
    """Store the leaves named in ``BF16_LEAVES`` in bf16 (exact: the JAX
    code rounds them the same way at every use); the rest stay f32."""
    if isinstance(tree, dict):
        return {k: (v.to(BF16) if k in BF16_LEAVES and torch.is_tensor(v)
                    else cast_bf16_leaves(v)) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_block(cfg: ModelConfig, gen, kind: str, device) -> Params:
    d = cfg.d_model
    p: Params = {"ln1": torch.ones((d,), dtype=F32, device=device)}
    if kind == "ssm":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, device=device)
        return p
    p["attn"] = init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                          cfg.qkv_bias, device=device)
    p["ln2"] = torch.ones((d,), dtype=F32, device=device)
    p["mlp"] = init_mlp(gen, d, cfg.d_ff, device=device)
    return p


def _block_kind(cfg: ModelConfig) -> str:
    check_supported(cfg)
    return "ssm" if cfg.family in ("ssm", "hybrid") else "dense"


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random parameters drawn from a ``torch.Generator`` seeded by
    ``seed`` on ``device`` (the draws differ from ``jax.random``'s: a test
    that compares the packages converts JAX's tree with
    ``convert.params_from_jax``).  Layer leaves are stacked [L, ...];
    the ``BF16_LEAVES`` are stored in bf16, every other leaf in f32."""
    device = resolve_device(device)
    kind = _block_kind(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, Vp = cfg.d_model, cfg.vocab_padded

    def one(init):
        # cast each layer as it is drawn: the f32 copy of the whole stack
        # is never held at once
        return cast_bf16_leaves(init())

    params: Params = {
        "embed": (torch.randn((Vp, d), generator=gen, dtype=F32,
                              device=device) * 0.02).to(BF16),
        "final_norm": torch.ones((d,), dtype=F32, device=device),
        "unembed": (torch.randn((d, Vp), generator=gen, dtype=F32,
                                device=device) * d ** -0.5).to(BF16),
        "blocks": _stack([one(lambda: _init_block(cfg, gen, kind, device))
                          for _ in range(cfg.n_layers)]),
    }
    if cfg.family == "hybrid":
        params["shared_attn"] = one(
            lambda: _init_block(cfg, gen, "dense", device))
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _dense_block(p, x, cfg, positions, *, cache=None, cache_len=None):
    """Residual attention block followed by the dense MLP.
    Returns (x, new_cache, aux)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = attn_block(
        p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.d_head, rope_theta=cfg.rope_theta, positions=positions,
        impl=cfg.attn_impl, cache_kv=cache, cache_len=cache_len)
    x = x + a
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    y = mlp(p["mlp"], h2)
    return x + y, new_cache, torch.zeros((), dtype=F32, device=x.device)


def _ssm_res_block(p, x, cfg, *, mode="train", state=None):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    y, new_state = ssm_mod.ssm_block(p["ssm"], h, cfg, mode=mode, state=state,
                                     impl=cfg.ssm_impl)
    return x + y, new_state


# ---------------------------------------------------------------------------
# Embedding / stacks
# ---------------------------------------------------------------------------
def embed_tokens(params, tokens, cfg):
    return params["embed"].to(BF16)[tokens]


def _run_stack(cfg, params, x, positions, *, mode, cache=None,
               cache_len=None):
    """Apply the layer stack.  Returns (x, new_cache, aux).

    ``cache`` (decode) / the returned cache (prefill) holds stacked
    [L, ...] leaves, as the JAX package's: ``"layers"`` for dense stacks,
    ``"ssm"`` (+ ``"attn"`` for zamba2's shared-attention applications)
    for ssm/hybrid stacks.  Decode updates ``cache`` in place.
    """
    if _block_kind(cfg) == "ssm":
        return _run_ssm_stack(cfg, params, x, positions, mode=mode,
                              cache=cache, cache_len=cache_len)

    aux_total = torch.zeros((), dtype=F32, device=x.device)
    kvs = []
    for i in range(cfg.n_layers):
        c_i = None if cache is None else _layer(cache["layers"], i)
        x, c, aux = _dense_block(_layer(params["blocks"], i), x, cfg,
                                 positions, cache=c_i, cache_len=cache_len)
        aux_total = aux_total + aux
        kvs.append(c)
    new_cache: Dict[str, Any] = {}
    if mode == "decode":
        new_cache["layers"] = cache["layers"]      # updated in place
    elif mode != "train":
        new_cache["layers"] = _stack(kvs)
    return x, new_cache, aux_total


def _run_ssm_stack(cfg, params, x, positions, *, mode, cache, cache_len):
    """Mamba2 stack; zamba2 interleaves one *shared* attention block every
    ``attn_every`` layers (its own KV cache per application).

    * train:   no caches carried at all;
    * prefill: attention runs causal (cache=None path) and its fresh (k, v)
      is written into the application's slot of the attention cache;
    * decode:  attention reads/updates the application's cache slice, and
      every layer's SSM state is replaced in place.
    """
    hybrid = cfg.family == "hybrid"
    decode = mode == "decode" and x.shape[1] == 1
    ssm_mode = "decode" if decode else "train"
    B, S = x.shape[:2]

    attn_cache = None
    if hybrid and mode != "train":
        attn_cache = (cache["attn"] if cache is not None else
                      _hybrid_attn_cache(cfg, B, S, cfg.n_attn_applications,
                                         x.device))
    states = []
    app_idx = 0
    for i in range(cfg.n_layers):
        s_l = None if cache is None else _layer(cache["ssm"], i)
        x, s_new = _ssm_res_block(_layer(params["blocks"], i), x, cfg,
                                  mode=ssm_mode, state=s_l)
        states.append(s_new)
        if hybrid and i % cfg.attn_every == cfg.attn_every - 1:
            if decode:
                c_a = _layer(attn_cache, app_idx)
                x, c_new, _ = _dense_block(params["shared_attn"], x, cfg,
                                           positions, cache=c_a,
                                           cache_len=cache_len)
            else:
                x, c_new, _ = _dense_block(params["shared_attn"], x, cfg,
                                           positions)
            if mode != "train" and not decode:
                for full, one in zip(attn_cache, c_new):
                    full[app_idx] = one.to(full.dtype)
            app_idx += 1

    new_cache: Dict[str, Any] = {}
    if mode == "train":
        return x, new_cache, torch.zeros((), dtype=F32, device=x.device)
    if cache is not None:
        for full, one in zip(cache["ssm"], zip(*states)):
            for i, s in enumerate(one):
                full[i] = s.to(full.dtype)
        new_cache["ssm"] = cache["ssm"]
    else:
        new_cache["ssm"] = _stack(states)
    if hybrid:
        new_cache["attn"] = attn_cache
    return x, new_cache, torch.zeros((), dtype=F32, device=x.device)


def _hybrid_attn_cache(cfg, B, T, n_apps, device):
    shape = (n_apps, B, T, cfg.n_kv_heads, cfg.d_head)
    return (torch.zeros(shape, dtype=BF16, device=device),
            torch.zeros(shape, dtype=BF16, device=device))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def forward_train(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    """Returns (hidden [B,S,d], aux_loss)."""
    x = embed_tokens(params, batch["tokens"], cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, aux = _run_stack(cfg, params, x, positions, mode="train")
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    """Returns (last-position logits [B,Vp] f32, cache, seq_len)."""
    x = embed_tokens(params, batch["tokens"], cfg)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    x, cache, _ = _run_stack(cfg, params, x, positions, mode="prefill")
    h_last = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    logits = (h_last.to(BF16) @ params["unembed"].to(BF16)).to(F32)
    return logits, cache, S


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache, cache_len: int):
    """One decode step.  tokens [B,1] -> (logits [B,Vp] f32, cache), the
    cache updated in place at position ``cache_len``."""
    cache_len = int(cache_len)
    x = embed_tokens(params, tokens, cfg)
    positions = cache_len + torch.arange(x.shape[1], device=x.device)
    x, new_cache, _ = _run_stack(cfg, params, x, positions, mode="decode",
                                 cache=cache, cache_len=cache_len)
    h = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    logits = (h.to(BF16) @ params["unembed"].to(BF16)).to(F32)
    return logits, new_cache


# ---------------------------------------------------------------------------
# Decode-cache construction
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, device=None):
    """Empty decode cache sized for ``max_len`` positions."""
    device = resolve_device(device)
    kind = _block_kind(cfg)
    z = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    if kind == "ssm":
        H, Pd, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        ch = cfg.d_inner + 2 * cfg.ssm_state
        cache = {"ssm": (
            z((cfg.n_layers, batch_size, H, Pd, N), F32),
            z((cfg.n_layers, batch_size, cfg.conv_width - 1, ch), F32))}
        if cfg.family == "hybrid":
            cache["attn"] = _hybrid_attn_cache(
                cfg, batch_size, max_len, cfg.n_attn_applications, device)
        return cache
    shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"layers": (z(shape, BF16), z(shape, BF16))}
