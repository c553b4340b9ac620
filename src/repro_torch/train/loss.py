"""Chunked cross-entropy: never materializes the [B, S, V] f32 logits
(the JAX package's ``train/loss.py``).

The sequence axis is walked in ``logit_chunk`` slices by a Python loop
(the JAX code scans them); each chunk computes bf16 logits against the
vocab-padded unembedding, masks the padded vocab entries to -1e30 and
reduces the log-probs in f32.  Label -1 marks an ignored position.  The
unembedding is cast to bf16 inside each chunk, as there, so its gradient
reaches the f32 leaf chunk by chunk and is summed in f32.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.models.layers import BF16, F32


def chunked_cross_entropy(hidden: torch.Tensor, unembed: torch.Tensor,
                          labels: torch.Tensor, vocab_real: int,
                          chunk: int = 512
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden [B,S,d], unembed [d,Vp], labels [B,S] -> (sum_nll, n_valid),
    both f32 scalars."""
    B, S, d = hidden.shape
    Vp = unembed.shape[1]
    chunk = min(chunk, S)
    n_chunks = S // chunk
    rem = S - n_chunks * chunk
    pad_mask = torch.arange(Vp, device=hidden.device) < vocab_real

    def chunk_loss(h_c, l_c):
        logits = (h_c.to(BF16) @ unembed.to(BF16)).to(F32)
        if vocab_real < Vp:
            logits = torch.where(pad_mask, logits,
                                 torch.full((), -1e30, dtype=F32,
                                            device=logits.device))
        lse = torch.logsumexp(logits, dim=-1)
        idx = l_c.clamp(0, Vp - 1).long()[..., None]
        ll = torch.gather(logits, -1, idx)[..., 0]
        valid = (l_c >= 0).to(F32)
        return ((lse - ll) * valid).sum(), valid.sum()

    nll = n = torch.zeros((), dtype=F32, device=hidden.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        nll_i, n_i = chunk_loss(hidden[:, sl], labels[:, sl])
        nll, n = nll + nll_i, n + n_i
    if rem:
        nll_r, n_r = chunk_loss(hidden[:, -rem:], labels[:, -rem:])
        nll, n = nll + nll_r, n + n_r
    return nll, n


def lm_loss(hidden, unembed, labels, vocab_real, chunk=512, aux=None,
            aux_weight: float = 0.01, dp_group=None):
    """(mean next-token loss [+ aux_weight * aux], {nll, n_tokens, ce}).
    With ``dp_group`` (a rank's batch shard on a mesh) the mean is over
    the global batch: nll and the token count are summed over the group,
    the nll by a differentiable psum."""
    nll, n = chunked_cross_entropy(hidden, unembed, labels, vocab_real,
                                   chunk)
    if coll.size(dp_group) > 1:
        nll, n = coll.psum(nll, dp_group), coll.all_reduce_sum(n, dp_group)
    ce = nll / torch.clamp(n, min=1.0)
    loss = ce if aux is None else ce + aux_weight * aux
    return loss, {"nll": nll, "n_tokens": n, "ce": ce}
