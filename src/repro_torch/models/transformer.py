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

Every entry point takes the JAX entry point's ``mesh`` and ``dp``.  On a
mesh of several ranks each rank runs the whole stack on its batch rows
(``train/step.py:local_batch`` in training, ``sharding.batch_rows`` in
serving) with each parameter leaf held as its shard and gathered as its
layer runs (``sharding.Gatherer``), and the moe layer runs its
expert-parallel body across the mesh (``models/moe.py``).  In serving the
entry points take the global batch (and the global decode tokens) and
return the rank's rows of the logits; a decode cache is a
:class:`ShardedCache`, each leaf the rank's shard under
``sharding.cache_specs`` (its batch rows; heads, or else time, split over
``model``; the ssm state's heads over ``model``), gathered over ``model``
a layer at a time as the layer runs, the position a step writes put back
into the shard.  A prefill returns its rows' cache whole over ``model``
(``serve/step.py`` loads it into the shards).  A mesh of one rank is the
one-card path.  The JAX package's activation constraints and sequence
parallelism are layouts of the same math; :func:`_sp_mode` decides the
mode as the JAX code does, and the port computes every mode with the
sequence whole.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import resolve_device
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import sharding as shd
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


def on_mesh(mesh) -> bool:
    """Whether ``mesh`` has several ranks (a mesh of one is one card)."""
    return mesh is not None and mesh.size() > 1


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
                 kind="dense", mesh=None, dp=("data",), global_aux=True):
    """Residual attention (or MLA) block followed by the MLP or the MoE
    layer (on ``mesh``, expert-parallel over it; ``global_aux`` as
    ``moe.moe_layer`` takes it).  Returns (x, new_cache, aux)."""
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
        y, aux = moe_mod.moe_layer(p["moe"], h2, cfg, mesh, dp,
                                   global_aux=global_aux)
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
    layers = None if cache is None else _Layers(cache)
    for key, blocks, n, k in (("first", "first_blocks", n_first, first_kind),
                              ("layers", "blocks", cfg.n_layers - n_first,
                               kind)):
        kvs = []
        for i in range(n):
            c_i = None if layers is None else layers.get(key, i)
            x, c, aux = _dense_block(
                _fetched(fetch, blocks, _layer(params[blocks], i)), x, cfg,
                positions, cache=c_i, cache_len=cache_len, kind=k,
                mesh=mesh, dp=dp, global_aux=False)
            aux_total = aux_total + aux
            if layers is None:
                kvs.append(c)
            else:
                layers.put(key, i, c, slice(cache_len,
                                            cache_len + x.shape[1]))
        if n and cache is None:
            new_cache[key] = _stack(kvs)
    return x, (new_cache if cache is None else cache), aux_total  # in place


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

    layers = None if cache is None else _Layers(cache)
    attn_cache = None
    if hybrid and cache is None:
        attn_cache = _hybrid_attn_cache(cfg, B, S, cfg.n_attn_applications,
                                        x.device)
    states = []
    app_idx = 0
    for i in range(cfg.n_layers):
        s_l = None if layers is None else layers.get("ssm", i)
        x, s_new = _ssm_res_block(
            _fetched(fetch, "blocks", _layer(params["blocks"], i)), x, cfg,
            mode=ssm_mode, state=s_l)
        if layers is None:
            states.append(s_new)
        else:
            layers.put("ssm", i, s_new)
        if hybrid and i % cfg.attn_every == cfg.attn_every - 1:
            if layers is not None:
                x, c_new, _ = _dense_block(
                    params["shared_attn"], x, cfg, positions,
                    cache=layers.get("attn", app_idx), cache_len=cache_len)
                layers.put("attn", app_idx, c_new,
                           slice(cache_len, cache_len + x.shape[1]))
            else:
                x, c_new, _ = _dense_block(params["shared_attn"], x, cfg,
                                           positions)
                for full, one in zip(attn_cache, c_new):
                    full[app_idx] = one.to(full.dtype)
            app_idx += 1

    if cache is not None:                     # updated in place
        return x, cache, torch.zeros((), dtype=F32, device=x.device)
    new_cache: Dict[str, Any] = {"ssm": _stack(states)}
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


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            mesh=None, dp: tuple = ("data",), gatherer=None):
    """Returns (last-position logits [B,Vp] f32, cache, seq_len).  On a
    mesh of several ranks, ``params`` the rank's shards and ``batch`` the
    global batch: the logits and the cache (whole over ``model``) of the
    rank's rows.  ``gatherer``: the ``sharding.Gatherer`` that gathers
    the shards (one is made where none is given)."""
    fetch = None
    if on_mesh(mesh):
        g = gatherer or shd.Gatherer(cfg, mesh, differentiable=False)
        params, fetch = g.top(params), g.fetch
        batch = shd.batch_rows(batch, mesh, dp)
    x = _assemble_input(params, batch, cfg)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    x, cache, _ = _run_stack(cfg, params, x, positions, mode="prefill",
                             mesh=mesh, dp=dp, fetch=fetch)
    h_last = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    logits = (h_last.to(BF16) @ params["unembed"].to(BF16)).to(F32)
    return logits, cache, S


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache, cache_len: int, mesh=None, dp: tuple = ("data",),
                gatherer=None):
    """One decode step.  tokens [B,1] -> (logits [B,Vp] f32, cache), the
    cache updated in place at position ``cache_len``.  On a mesh of
    several ranks, ``params`` the rank's shards, ``tokens`` the global
    tokens and ``cache`` the rank's :class:`ShardedCache`: the logits of
    the rank's rows.  ``gatherer`` as :func:`prefill`'s."""
    cache_len = int(cache_len)
    fetch = None
    if on_mesh(mesh):
        if not isinstance(cache, ShardedCache) or cache.mesh is not mesh:
            raise TypeError("on a mesh the decode cache is the rank's "
                            "ShardedCache on that mesh (init_cache(..., "
                            "mesh=))")
        rows = shd.batch_axis(mesh, tokens.shape[0], dp)
        if cache.rows != rows:
            raise ValueError(f"the cache's rows split over {cache.rows}, "
                             f"the batch's over {rows}")
        g = gatherer or shd.Gatherer(cfg, mesh, differentiable=False)
        params, fetch = g.top(params), g.fetch
        tokens = shd.batch_rows({"tokens": tokens}, mesh, dp)["tokens"]
    x = embed_tokens(params, tokens, cfg)
    positions = cache_len + torch.arange(x.shape[1], device=x.device)
    x, new_cache, _ = _run_stack(cfg, params, x, positions, mode="decode",
                                 cache=cache, cache_len=cache_len,
                                 mesh=mesh, dp=dp, fetch=fetch)
    h = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    logits = (h.to(BF16) @ params["unembed"].to(BF16)).to(F32)
    return logits, new_cache


# ---------------------------------------------------------------------------
# Decode-cache construction
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, device=None,
               mesh=None):
    """Empty decode cache sized for ``max_len`` positions; on a mesh of
    several ranks, the rank's :class:`ShardedCache` of it."""
    device = resolve_device(device)
    if on_mesh(mesh):
        return ShardedCache.zeros(cfg, batch_size, max_len, device, mesh)
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


def _shard_shape(shape, spec, mesh):
    sizes = axis_sizes(mesh)
    return tuple(d // math.prod(sizes[a] for a in shd._axes_of(e))
                 for d, e in zip(shape, spec)) + tuple(shape[len(spec):])


class ShardedCache(dict):
    """A rank's decode cache on a mesh: ``init_cache``'s tree (``"ssm"``,
    ``"attn"``, ``"layers"``, ``"first"``: tuples of stacked leaves), each
    leaf the rank's shard under ``sharding.cache_specs`` (``specs``, the
    tree of specs; ``rows``, the axes of its batch rows)."""

    def __init__(self, leaves, specs, mesh, rows):
        super().__init__(leaves)
        self.specs, self.mesh, self.rows = specs, mesh, rows

    @classmethod
    def zeros(cls, cfg, batch_size, max_len, device, mesh):
        shapes = init_cache(cfg, batch_size, max_len, device="meta")
        specs = shd.cache_specs(cfg, shapes, mesh, batch_size)
        leaves = shd.map_specs(lambda sp, a: torch.zeros(
            _shard_shape(a.shape, sp, mesh), dtype=a.dtype, device=device),
            specs, shapes)
        rows = shd.batch_axis(mesh, batch_size)
        return cls(leaves, specs, mesh, rows)


class _Layers:
    """Layer i of a decode cache as the stack runs.  One card (a plain
    tree): views of the leaves, which attention updates in place; a new
    state is copied in.  A :class:`ShardedCache`: the layer of the rank's
    shard gathered over ``model`` (the rank's rows, whole heads and time),
    and what the layer writes put back into the shard."""

    def __init__(self, cache):
        self.cache = cache
        self.mesh = cache.mesh if isinstance(cache, ShardedCache) else None

    def _spec(self, key, j):
        """The spec of one layer of leaf j of ``key``, over the rank's
        rows: the layer and batch entries dropped."""
        return shd.P(None, *self.cache.specs[key][j][2:])

    def _gathered(self, key, j) -> bool:
        """Whether leaf j of ``key`` splits over ``model`` on a mesh."""
        return self.mesh is not None and any(
            e is not None for e in self._spec(key, j))

    def get(self, key, i):
        return tuple(shd.gather(a[i], self._spec(key, j), self.mesh,
                                differentiable=False)
                     if self._gathered(key, j) else a[i]
                     for j, a in enumerate(self.cache[key]))

    def put(self, key, i, new, time=None):
        """Layer i's leaves ``new`` (as :meth:`get` gave them, written in
        place, or new tensors) into the cache: positions ``time`` (a
        slice) of an attention leaf [b, T, ...], or the whole of a
        state."""
        for j, (full, one) in enumerate(zip(self.cache[key], new)):
            if not self._gathered(key, j):
                if time is None:
                    full[i] = one.to(full.dtype)
                continue                 # attention wrote into the view
            sl = shd.shard_slices(self._spec(key, j), one.shape, self.mesh)
            if time is None:
                full[i] = one[sl].to(full.dtype)
                continue
            t = sl[1]
            lo, hi = max(time.start, t.start), min(time.stop, t.stop)
            if lo < hi:
                full[i][:, lo - t.start:hi - t.start] = \
                    one[(sl[0], slice(lo, hi)) + sl[2:]].to(full.dtype)
