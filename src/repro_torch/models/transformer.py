"""Decoder assembly for every architecture family.

The PyTorch counterpart of the JAX package's ``models/transformer.py``:
one parameter tree and the entry points

* ``forward_train`` — full causal forward, returns (hidden, aux_loss)
  (``train/step.py`` differentiates it);
* ``prefill``       — forward that also returns the per-layer cache;
* ``decode_step``   — one-token step against the cache.

Layer parameters are stacked ([L, ...] leaves, under the JAX names) and a
Python loop walks the layers where the JAX code scans them; deepseek's
leading dense layers live apart (``params["first_blocks"]``,
``cache["first"]``), as there.  With ``cfg.remat``, a training forward
under grad mode runs each layer body under ``torch.utils.checkpoint``,
as the JAX code wraps its scan body in ``jax.checkpoint``.  MLA runs the
reference attention only (``check_supported``).

``forward_train`` takes the JAX entry point's ``mesh`` and ``dp``: on a
mesh (``train/step.py``) a rank runs the whole stack on its batch shard
with the weights gathered, and the moe layer runs its expert-parallel body
across the mesh (``models/moe.py``).  The JAX package's activation
constraints and sequence parallelism are layouts of the same math;
:func:`_sp_mode` decides the mode as the JAX code does, and the port
computes every mode with the sequence whole.  Serving (``prefill``,
``decode_step``) runs on one card.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import resolve_device
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    BF16, F32, attn_block, init_attn, init_mlp, mlp, rmsnorm,
)

Params = Dict[str, Any]

# leaves the JAX code casts to bf16 at every use: stored in bf16 once
BF16_LEAVES = frozenset({"embed", "unembed", "wq", "wk", "wv", "wo", "bq",
                         "bk", "bv", "w_gate", "w_up", "w_down", "in_proj",
                         "out_proj", "router", "w_dq", "w_uq", "w_dkv",
                         "w_uk", "w_uv"})


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for what the port cannot run: MLA with the
    flash-attention kernel (``mla.check_impl``)."""
    if cfg.use_mla:
        mla_mod.check_impl(cfg)


def map_leaves(fn, tree):
    """``fn`` applied to every tensor of a nested dict/tuple tree."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map_leaves(fn, v) for v in tree)
    return fn(tree)


def _layer(tree, i: int):
    return map_leaves(lambda a: a[i], tree)


def _unstack(tree):
    """The per-layer trees of a stacked [L, ...] tree, as views from one
    ``torch.unbind`` a leaf: in the backward, one node stacks the L
    layers' gradients, where a per-layer index would add a full [L, ...]
    gradient for each layer."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _maybe_remat(fn, cfg):
    """``fn`` under ``torch.utils.checkpoint`` when ``cfg.remat`` and grad
    mode is on (the JAX package's ``jax.checkpoint(policy=
    nothing_saveable)`` on the scan body): the layer keeps its inputs, and
    the backward reruns its forward, kernels and collectives included (a
    moe layer's rerun routes as its forward did:
    ``moe.remat_contexts``)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    context_fn=moe_mod.remat_contexts)


def _sp_mode(cfg, mesh, S: int, decode: bool) -> str:
    """The sequence-parallel mode the JAX package takes at this call site
    (``repro/models/transformer.py:_sp_mode``): 'off' without a mesh of
    several ranks with a ``model`` axis that divides S, in decode, or as
    configured."""
    if (cfg.seq_parallel == "off" or mesh is None or mesh.size() == 1
            or decode or "model" not in mesh.mesh_dim_names):
        return "off"
    if S % axis_sizes(mesh)["model"] != 0:
        return "off"
    return cfg.seq_parallel


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
    if cfg.use_mla:
        p["attn"] = mla_mod.init_mla(gen, cfg, device=device)
    else:
        p["attn"] = init_attn(gen, d, cfg.n_heads, cfg.n_kv_heads,
                              cfg.d_head, cfg.qkv_bias, device=device)
    p["ln2"] = torch.ones((d,), dtype=F32, device=device)
    if kind == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, device=device)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, device=device)
    return p


def _block_kinds(cfg: ModelConfig) -> Tuple[str, str, int]:
    """(first-layers kind, stacked kind, n_first)."""
    check_supported(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return "ssm", "ssm", 0
    if cfg.family == "moe":
        return "dense", "moe", cfg.first_dense
    return "dense", "dense", 0


def _kept(keep, tree, path):
    """``keep(path, leaf)`` over a tree of dicts (identity without
    ``keep``)."""
    if keep is None:
        return tree
    if isinstance(tree, dict):
        return {k: _kept(keep, v, path + (k,)) for k, v in tree.items()}
    return keep(path, tree)


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                masters: bool = False, keep=None) -> Params:
    """Random parameters drawn from a ``torch.Generator`` seeded by
    ``seed`` on ``device`` (the draws differ from ``jax.random``'s: a test
    that compares the packages converts JAX's tree with
    ``convert.params_from_jax``; on the ``meta`` device, the shapes
    alone).  Layer leaves are stacked [L, ...];
    the ``BF16_LEAVES`` are stored in bf16, every other leaf in f32 —
    or, with ``masters`` (training: AdamW updates f32 masters, as the JAX
    package's leaves are), every leaf in f32.  Each use casts to bf16, so
    a bf16 tree serves as its f32 masters do.

    ``keep(path, leaf)``, where given, takes each leaf as it is drawn and
    returns what the tree keeps of it (a rank's shard on a mesh): a
    stacked leaf one layer at a time, its path starting with ``blocks`` or
    ``first_blocks``.  The draws are the same, and no more than one layer
    or the embedding is ever held whole."""
    device = resolve_device(device)
    first_kind, kind, n_first = _block_kinds(cfg)
    gen = None                  # the meta device: shapes only
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    d, Vp = cfg.d_model, cfg.vocab_padded
    cast = (lambda t: t) if masters else cast_bf16_leaves
    store = F32 if masters else BF16

    def leaf(name, t):
        return _kept(keep, t, (name,))

    def stack(name, kind, n):
        # cast (and keep) each layer as it is drawn: the f32 copy of the
        # whole stack is never held at once
        return _stack([leaf(name, cast(_init_block(cfg, gen, kind, device)))
                       for _ in range(n)])

    params: Params = {
        "embed": leaf("embed", (torch.randn(
            (Vp, d), generator=gen, dtype=F32, device=device)
            * 0.02).to(store)),
        "final_norm": leaf("final_norm", torch.ones((d,), dtype=F32,
                                                    device=device)),
        "unembed": leaf("unembed", (torch.randn(
            (d, Vp), generator=gen, dtype=F32, device=device)
            * d ** -0.5).to(store)),
        "blocks": stack("blocks", kind, cfg.n_layers - n_first),
    }
    if n_first:
        params["first_blocks"] = stack("first_blocks", first_kind, n_first)
    if cfg.family == "hybrid":
        params["shared_attn"] = leaf("shared_attn", cast(_init_block(
            cfg, gen, "dense", device)))
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _dense_block(p, x, cfg, positions, *, cache=None, cache_len=None,
                 kind="dense", mesh=None, dp=("data",)):
    """Residual attention (or MLA) block followed by the MLP or the MoE
    layer (on ``mesh``, expert-parallel over it).  Returns (x, new_cache,
    aux)."""
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        if cache is None:
            a, new_cache = mla_mod.mla_prefill(p["attn"], h, cfg, positions)
        else:
            a, new_cache = mla_mod.mla_decode(p["attn"], h, cfg, positions,
                                              cache, cache_len)
    else:
        a, new_cache = attn_block(
            p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            d_head=cfg.d_head, rope_theta=cfg.rope_theta,
            positions=positions, impl=cfg.attn_impl, cache_kv=cache,
            cache_len=cache_len)
    x = x + a
    h2 = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if kind == "moe":
        y, aux = moe_mod.moe_layer(p["moe"], h2, cfg, mesh, dp)
    else:
        y, aux = mlp(p["mlp"], h2), torch.zeros((), dtype=F32,
                                                device=x.device)
    return x + y, new_cache, aux


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


def _assemble_input(params, batch, cfg):
    """Token or stub-frontend embedding -> x [B,S,d] bf16 (see
    ``config.frontend``): paligemma's patch embeddings ahead of its text
    tokens, musicgen's frame embeddings alone."""
    if cfg.frontend == "patch_embeds":
        prefix = batch["patch_embeds"].to(BF16)               # [B,Np,d]
        text = embed_tokens(params, batch["tokens"], cfg)
        return torch.cat([prefix, text], dim=1)
    if cfg.frontend == "frame_embeds":
        return batch["frame_embeds"].to(BF16)                 # [B,S,d]
    return embed_tokens(params, batch["tokens"], cfg)


def _run_stack(cfg, params, x, positions, *, mode, cache=None,
               cache_len=None, mesh=None, dp=("data",), fetch=None):
    """Apply the leading layers, then the stacked ones.  Returns (x,
    new_cache, aux).

    ``cache`` (decode) / the returned cache (prefill) holds stacked
    [L, ...] leaves, as the JAX package's: ``"layers"`` for the stacked
    attention layers and ``"first"`` for the leading ones, ``"ssm"`` (+
    ``"attn"`` for zamba2's shared-attention applications) for ssm/hybrid
    stacks.  Decode updates ``cache`` in place.
    """
    first_kind, kind, n_first = _block_kinds(cfg)
    if kind == "ssm":
        return _run_ssm_stack(cfg, params, x, positions, mode=mode,
                              cache=cache, cache_len=cache_len, fetch=fetch)

    aux_total = torch.zeros((), dtype=F32, device=x.device)
    new_cache: Dict[str, Any] = {}
    if mode == "train":
        for blocks, k in (("first_blocks", first_kind), ("blocks", kind)):
            if blocks not in params:
                continue
            body = _maybe_remat(
                lambda p, h, k=k, blocks=blocks: _dense_block(
                    _fetched(fetch, blocks, p), h, cfg, positions, kind=k,
                    mesh=mesh, dp=dp)[::2], cfg)
            for p in _unstack(params[blocks]):
                x, aux = body(p, x)
                aux_total = aux_total + aux
        return x, new_cache, aux_total
    for key, blocks, n, k in (("first", "first_blocks", n_first, first_kind),
                              ("layers", "blocks", cfg.n_layers - n_first,
                               kind)):
        kvs = []
        for i in range(n):
            c_i = None if cache is None else _layer(cache[key], i)
            x, c, aux = _dense_block(_layer(params[blocks], i), x, cfg,
                                     positions, cache=c_i,
                                     cache_len=cache_len, kind=k)
            aux_total = aux_total + aux
            kvs.append(c)
        if not n:
            continue
        new_cache[key] = (cache[key] if mode == "decode"    # in place
                          else _stack(kvs))
    return x, new_cache, aux_total


def _fetched(fetch, name, layer):
    return layer if fetch is None else fetch(name, layer)


def _run_ssm_stack(cfg, params, x, positions, *, mode, cache, cache_len,
                   fetch=None):
    """Mamba2 stack; zamba2 interleaves one *shared* attention block every
    ``attn_every`` layers (its own KV cache per application).

    * train:   no caches carried at all; a layer body (the Mamba2 block,
      and the shared attention after it where it fires) is the remat
      unit, as the JAX scan body is;
    * prefill: attention runs causal (cache=None path) and its fresh (k, v)
      is written into the application's slot of the attention cache;
    * decode:  attention reads/updates the application's cache slice, and
      every layer's SSM state is replaced in place.
    """
    hybrid = cfg.family == "hybrid"
    decode = mode == "decode" and x.shape[1] == 1
    ssm_mode = "decode" if decode else "train"
    B, S = x.shape[:2]
    if mode == "train":
        def body(p, h, i):
            h, _ = _ssm_res_block(_fetched(fetch, "blocks", p), h, cfg)
            if hybrid and i % cfg.attn_every == cfg.attn_every - 1:
                h, _, _ = _dense_block(params["shared_attn"], h, cfg,
                                       positions)
            return h
        body = _maybe_remat(body, cfg)
        for i, p in enumerate(_unstack(params["blocks"])):
            x = body(p, x, i)
        return x, {}, torch.zeros((), dtype=F32, device=x.device)

    attn_cache = None
    if hybrid:
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
            if not decode:
                for full, one in zip(attn_cache, c_new):
                    full[app_idx] = one.to(full.dtype)
            app_idx += 1

    new_cache: Dict[str, Any] = {}
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
def forward_train(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
                  mesh=None, dp: tuple = ("data",), fetch=None):
    """Returns (hidden [B,S,d], aux_loss); on ``mesh``, of the rank's
    batch shard with the aux loss over the global batch.  ``fetch(name,
    layer)``, where given, turns one layer of the stacked leaves ``name``
    into the layer's parameters as it runs, inside its remat unit (on a
    mesh: gathers its shards)."""
    x = _assemble_input(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, aux = _run_stack(cfg, params, x, positions, mode="train",
                           mesh=mesh, dp=dp, fetch=fetch)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    """Returns (last-position logits [B,Vp] f32, cache, seq_len)."""
    x = _assemble_input(params, batch, cfg)
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
    first_kind, kind, n_first = _block_kinds(cfg)
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

    def attn_cache(n):
        if cfg.use_mla:
            return (z((n, batch_size, max_len, cfg.kv_lora_rank), BF16),
                    z((n, batch_size, max_len, cfg.qk_rope_dim), BF16))
        shape = (n, batch_size, max_len, cfg.n_kv_heads, cfg.d_head)
        return (z(shape, BF16), z(shape, BF16))

    cache = {"layers": attn_cache(cfg.n_layers - n_first)}
    if n_first:
        cache["first"] = attn_cache(n_first)
    return cache
