"""Serving steps: batched prefill and single-token decode with greedy or
top-k sampling — the PyTorch counterpart of the JAX package's
``serve/step.py``.  The decode cache layouts live in
``models/transformer.init_cache``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch: Dict[str, Any]):
        logits, cache, seq_len = transformer.prefill(cfg, params, batch)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_one(params, tokens: torch.Tensor, cache, cache_len: int):
        """tokens [B,1] -> (next token [B], logits, cache')."""
        logits, cache = transformer.decode_step(cfg, params, tokens, cache,
                                                cache_len)
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


def generate(cfg: ModelConfig, params, batch, n_steps: int,
             max_len: int | None = None):
    """Greedy generation: prefill, then a Python loop over decode steps.
    Returns the generated tokens [B, n_steps] (int32)."""
    first_tok, _, cache, seq_len = start(cfg, params, batch, n_steps,
                                         max_len)
    return decode_loop(cfg, params, first_tok, cache, seq_len, n_steps)[0]


def start(cfg: ModelConfig, params, batch, n_steps: int,
          max_len: int | None = None):
    """The prefill of ``generate``: (first token [B], last-position logits,
    the decode cache sized ``max_len`` or seq_len + n_steps, seq_len)."""
    first_tok, logits, pf_cache = make_prefill_step(cfg)(params, batch)
    seq_len = _batch_seq_len(cfg, batch)
    cache = transformer.init_cache(cfg, first_tok.shape[0],
                                   max_len or (seq_len + n_steps),
                                   device=first_tok.device)
    return first_tok, logits, _load_prefill(cfg, cache, pf_cache,
                                            seq_len), seq_len


def decode_loop(cfg: ModelConfig, params, tok, cache, seq_len: int,
                n_steps: int):
    """The decode loop of ``generate`` from token ``tok`` at ``seq_len``:
    (tokens [B, n_steps] int32, each step's logits [B, n_steps, Vp])."""
    decode = make_decode_step(cfg)
    toks, logits = [], []
    for i in range(n_steps):
        tok, lg, cache = decode(params, tok[:, None], cache, seq_len + i)
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
    key) into positions [0, seq_len), SSM states replaced."""
    for key, full_tree in cache.items():
        for full, part in zip(full_tree, pf_cache[key]):
            if key == "ssm":
                full.copy_(part)
            else:
                full[:, :, :part.shape[2]] = part.to(full.dtype)
    return cache
