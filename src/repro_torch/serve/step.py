"""Serving steps: batched prefill and single-token decode with greedy or
top-k sampling — the PyTorch counterpart of the JAX package's
``serve/step.py``, on one card or on a device mesh (``mesh=``, ``dp=``
as the JAX steps take them).  The decode cache layouts live in
``models/transformer.init_cache``.

On a mesh of several ranks every rank runs these steps on its own
process (``models/transformer.py``): the parameters are the rank's shards
(:func:`init_params`), the prefill takes the global batch and the decode
step the global tokens, each step returns the next token and the logits
of the rank's rows, and the decode cache is the rank's
``transformer.ShardedCache``.  :func:`generate` returns the global tokens
on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models import sharding as shd
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def init_params(cfg: ModelConfig, seed: int = 0, device=None, mesh=None,
                masters: bool = False):
    """``transformer.init_params`` from ``seed``; on a mesh of several
    ranks, this rank's shards of them (``sharding.param_specs``), each
    leaf cut as it is drawn."""
    keep = shd.shard_keeper(cfg, mesh) if transformer.on_mesh(mesh) \
        else None
    return transformer.init_params(cfg, seed, device, masters=masters,
                                   keep=keep)


def _gatherer(cfg: ModelConfig, mesh):
    """The step's ``sharding.Gatherer`` on a mesh of several ranks."""
    if not transformer.on_mesh(mesh):
        return None
    return shd.Gatherer(cfg, mesh, differentiable=False)


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      dp: tuple = ("data",)) -> Callable:
    g = _gatherer(cfg, mesh)

    def prefill_step(params, batch: Dict[str, Any]):
        logits, cache, seq_len = transformer.prefill(
            cfg, params, batch, mesh=mesh, dp=dp, gatherer=g)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None,
                     dp: tuple = ("data",)) -> Callable:
    g = _gatherer(cfg, mesh)

    def decode_one(params, tokens: torch.Tensor, cache, cache_len: int):
        """tokens [B,1] -> (next token [B], logits, cache')."""
        logits, cache = transformer.decode_step(
            cfg, params, tokens, cache, cache_len, mesh=mesh, dp=dp,
            gatherer=g)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache
    return decode_one


def sample_top_k(gen: torch.Generator, logits: torch.Tensor, k: int = 40,
                 temperature: float = 1.0) -> torch.Tensor:
    """One draw per row from the ``k`` largest logits at ``temperature``,
    with the random numbers from ``gen``."""
    vals, idx = torch.topk(logits / max(temperature, 1e-4), k, dim=-1)
    choice = torch.multinomial(torch.softmax(vals.float(), dim=-1), 1,
                               generator=gen)
    return torch.take_along_dim(idx, choice, dim=-1)[..., 0]


def generate(cfg: ModelConfig, params, batch, n_steps: int, mesh=None,
             dp: tuple = ("data",), max_len: int | None = None):
    """Greedy generation: prefill, then a Python loop over decode steps.
    Returns the generated tokens [B, n_steps] (int32); on a mesh, the
    global tokens on every rank."""
    first_tok, _, cache, seq_len = start(cfg, params, batch, n_steps,
                                         max_len, mesh, dp)
    toks = decode_loop(cfg, params, first_tok, cache, seq_len, n_steps,
                       mesh, dp)[0]
    return all_rows(toks, cache)


def all_rows(rows: torch.Tensor, cache) -> torch.Tensor:
    """The global rows from the ranks' ``rows`` of a ShardedCache's batch
    (``rows`` as they are off a mesh)."""
    if not isinstance(cache, transformer.ShardedCache):
        return rows
    return shd.gather(rows, shd.P(cache.rows), cache.mesh,
                      differentiable=False)


def start(cfg: ModelConfig, params, batch, n_steps: int,
          max_len: int | None = None, mesh=None, dp: tuple = ("data",)):
    """The prefill of ``generate``: (first token [B], last-position logits,
    the decode cache sized ``max_len`` or seq_len + n_steps, seq_len); on
    a mesh, of the rank's rows, the cache the rank's ShardedCache."""
    first_tok, logits, pf_cache = make_prefill_step(cfg, mesh, dp)(params,
                                                                   batch)
    seq_len = _batch_seq_len(cfg, batch)
    B = next(iter(batch.values())).shape[0]
    cache = transformer.init_cache(cfg, B, max_len or (seq_len + n_steps),
                                   device=first_tok.device, mesh=mesh)
    return first_tok, logits, _load_prefill(cfg, cache, pf_cache,
                                            seq_len), seq_len


def decode_loop(cfg: ModelConfig, params, tok, cache, seq_len: int,
                n_steps: int, mesh=None, dp: tuple = ("data",)):
    """The decode loop of ``generate`` from token ``tok`` at ``seq_len``:
    (tokens [B, n_steps] int32, each step's logits [B, n_steps, Vp]); on
    a mesh, of the rank's rows (``tok`` too), each step's tokens gathered
    to the global tokens the next step takes."""
    decode = make_decode_step(cfg, mesh, dp)
    toks, logits = [], []
    for i in range(n_steps):
        tok, lg, cache = decode(params, all_rows(tok, cache)[:, None],
                                cache, seq_len + i)
        toks.append(tok)
        logits.append(lg)
    if not n_steps:
        return (torch.zeros((tok.shape[0], 0), dtype=torch.int32,
                            device=tok.device), None)
    return torch.stack(toks, dim=1), torch.stack(logits, dim=1)


def _batch_seq_len(cfg, batch) -> int:
    if cfg.frontend == "patch_embeds":
        return batch["patch_embeds"].shape[1] + batch["tokens"].shape[1]
    if cfg.frontend == "frame_embeds":
        return batch["frame_embeds"].shape[1]
    return batch["tokens"].shape[1]


def _load_prefill(cfg, cache, pf_cache, seq_len: int):
    """Copy prefill-sized cache entries into the max_len decode cache (in
    place; returns ``cache``): attention k/v (MLA: the latent and the rope
    key) into positions [0, seq_len), SSM states replaced.  Into a
    ShardedCache, the rank's part of each: its heads, and its positions
    below seq_len."""
    for key, full_tree in cache.items():
        for j, (full, part) in enumerate(zip(full_tree, pf_cache[key])):
            if isinstance(cache, transformer.ShardedCache):
                # the slices of the rank's shard, over its rows
                spec = shd.P(None, None, *cache.specs[key][j][2:])
                shape = list(part.shape)
                if key != "ssm":
                    shape[2] = full.shape[2] * shd._axis_size(
                        cache.mesh, spec[2]) if spec[2] else full.shape[2]
                sl = shd.shard_slices(spec, shape, cache.mesh)
                if key == "ssm":
                    full.copy_(part[sl])
                    continue
                t = sl[2]
                hi = min(t.stop, part.shape[2])
                if hi > t.start:
                    full[:, :, :hi - t.start] = part[
                        sl[:2] + (slice(t.start, hi),) + sl[3:]].to(
                            full.dtype)
            elif key == "ssm":
                full.copy_(part)
            else:
                full[:, :, :part.shape[2]] = part.to(full.dtype)
    return cache
