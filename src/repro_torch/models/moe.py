"""Mixture-of-Experts layer on one card: top-k routing and the capacity
dispatch.

The PyTorch counterpart of the JAX package's ``models/moe.py`` as its
serve CLI runs it on one device: ``python -m repro.launch.serve`` builds a
(1, 1) mesh, so ``moe_layer`` there takes ``moe_layer_ep`` and its
``_ep_shard`` at ``n_model = 1``.  That path packs each expert's tokens
into a fixed-capacity buffer [E, C, d] (GShard-style: an assignment past
its expert's C slots is dropped), runs the grouped SwiGLU and combines the
k results of each token weighted.  :func:`moe_layer` computes the same:

* each assignment's rank within its expert counts the earlier assignments
  to that expert in token-major order (stable arrival order);
  ``keep = rank < C``; the kept slots ``e C + rank`` are unique, so the
  pack into [E, C, d] is a copy;
* the grouped SwiGLU is three bf16 ``torch.bmm`` (plain products, which the
  JAX code computes outside any Pallas kernel);
* a token's k weighted results are added in order in bf16, rounded after
  each add, as the JAX scatter-add into a bf16 buffer does.

:func:`moe_layer_dense` is the dense oracle (every expert on every token,
no drop), the plain version the tests hold the dispatch against; nothing
on the serving path calls it.  The expert-parallel paths across shards
(``_ep_shard`` at ``n_model > 1``, ``_ep_a2a_shard``) are not ported.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as tF

from repro_torch.models.layers import BF16, F32, init_dense, init_mlp, mlp

# router logits within this many bf16 ulps of each other are a near tie
# (see RoutingLog.route): what a few layers of bf16 residual stream move
# them apart when two runs sum in different orders
NEAR_TIE_ULPS = 2


def init_moe(gen, cfg, device=None):
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    rn = lambda *shape: torch.randn(shape, generator=gen, dtype=F32,
                                    device=device)
    p = {
        "router": init_dense(gen, d, E, scale=0.02, device=device),
        "w_gate": rn(E, d, f) * d ** -0.5,
        "w_up": rn(E, d, f) * d ** -0.5,
        "w_down": rn(E, f, d) * f ** -0.5,
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.n_shared_experts * f,
                               device=device)
    return p


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis, largest first, ties to
    the lower index (as ``jax.lax.top_k``): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_topk(params, x, cfg):
    """Top-k routing probabilities.  Returns (weights [B,S,k] f32, idx
    [B,S,k] int64, aux_loss f32 scalar): the logits are a bf16 product
    cast to f32, the weights renormalised over the k, aux the standard
    load-balancing loss E * sum_i f_i p_i."""
    logits = (x.to(BF16) @ params["router"].to(BF16)).to(F32)
    probs = torch.softmax(logits, dim=-1)                        # [B,S,E]
    topw, topi = top_k(probs, cfg.top_k)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    E = cfg.n_experts
    onehot = tF.one_hot(topi, E).to(F32).sum(-2)                  # [B,S,E]
    f = onehot.mean((0, 1)) / cfg.top_k
    aux = E * torch.sum(f * probs.mean((0, 1)))
    return topw, topi, aux


def capacity(tokens: int, cfg) -> int:
    """Slots per expert for ``tokens`` tokens: tokens k cf / E rounded up
    to a multiple of 8, at least 8 (the JAX package's ``_capacity``)."""
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def dispatch_slots(topi: torch.Tensor, cfg):
    """The capacity dispatch of the A = T k assignments ``topi`` [..., k]
    holds, in token-major order: (keep [A] bool, slot [A] int64, C).  A
    kept assignment's slot is ``e C + rank``, its rank within expert e in
    arrival order; a dropped one's is E C (out of range)."""
    ek = topi.reshape(-1).long()
    A = ek.numel()
    E = cfg.n_experts
    C = capacity(A // cfg.top_k, cfg)
    sorted_e, order = torch.sort(ek, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e)   # expert's first place
    rank = torch.empty_like(ek)
    rank[order] = torch.arange(A, device=ek.device) - first
    keep = rank < C
    slot = torch.where(keep, ek * C + rank, torch.full_like(ek, E * C))
    return keep, slot, C


def moe_layer(params, x, cfg):
    """The single-card capacity-dispatch MoE layer (the JAX package's
    ``_ep_shard`` at one model shard).  x [B,S,d] -> (y [B,S,d] in
    x.dtype, aux)."""
    topw, topi, aux = router_topk(params, x, cfg)
    if _LOG is not None:
        topw, topi = _LOG.route(params, x, topw, topi)
    B, S, d = x.shape
    T, k, E = B * S, cfg.top_k, cfg.n_experts
    keep, slot, C = dispatch_slots(topi, cfg)
    if _LOG is not None:
        _LOG.drops.append((keep.numel(), (~keep).sum()))
    tok = torch.arange(T, device=x.device).repeat_interleave(k)

    # pack: kept assignments copied to their unique slots; the dropped
    # ones all land on row E C, which is cut away
    buf = torch.zeros((E * C + 1, d), dtype=BF16, device=x.device)
    buf.index_copy_(0, slot, x.reshape(T, d).to(BF16)[tok])
    buf = buf[:E * C].view(E, C, d)

    g = torch.bmm(buf, params["w_gate"].to(BF16))
    u = torch.bmm(buf, params["w_up"].to(BF16))
    h = tF.silu(g.to(F32)).to(BF16) * u
    y_buf = torch.bmm(h, params["w_down"].to(BF16)).reshape(E * C, d)

    # combine: each token's k results weighted (a dropped one by 0), added
    # in assignment order in bf16
    w = (topw.to(x.dtype).reshape(T * k) * keep).to(BF16)
    vals = (y_buf[slot.clamp(max=E * C - 1)] * w[:, None]).view(T, k, d)
    y = torch.zeros((T, d), dtype=BF16, device=x.device)
    for j in range(k):
        y = y + vals[:, j]
    y = y.view(B, S, d).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], x)
    return y, aux


def moe_layer_dense(params, x, cfg):
    """Dense oracle: every expert on every token, combined by gate (no
    capacity, no drop).  O(E) compute — the tests' plain version only."""
    topw, topi, aux = router_topk(params, x, cfg)
    gates = torch.sum(tF.one_hot(topi, cfg.n_experts).to(F32)
                      * topw[..., None], dim=-2)                  # [B,S,E]
    xb = x.to(BF16)
    g = torch.einsum("bsd,edf->bsef", xb, params["w_gate"].to(BF16))
    u = torch.einsum("bsd,edf->bsef", xb, params["w_up"].to(BF16))
    h = tF.silu(g.to(F32)).to(BF16) * u
    y_e = torch.einsum("bsef,efd->bsed", h, params["w_down"].to(BF16))
    y = torch.einsum("bsed,bse->bsd", y_e, gates.to(BF16)).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], x)
    return y, aux


# ---------------------------------------------------------------------------
# Routing log: what the tests and chip_smoke.py read and replay
# ---------------------------------------------------------------------------
class RoutingLog:
    """The routing of every :func:`moe_layer` call while the log is open
    (:func:`log_routing`): each call's top-k indices [B,S,k] (``topi``)
    and its (assignments, dropped at capacity) pair, the second a 0-d
    device tensor (``drops``).  Recording syncs nothing with the host.

    With ``replay`` (another run's ``topi``, call by call) each call is
    held to that run's routing: top-k is a discontinuous function, so two
    runs of one model whose sums differ in order (the JAX package and the
    port, the card and the CPU, a kernel and its plain version) can rank
    a near tie apart, and one token's experts then differ.  Where the
    indices differ, each differing position's two router logits must lie
    within ``tie_ulps`` bf16 ulps (of the token's largest |logit|) of
    each other, else ``route`` raises; the replayed indices are taken,
    with this run's weights at them.  ``replaced`` counts the differing
    positions a call.
    """

    def __init__(self, replay=None, tie_ulps: float = NEAR_TIE_ULPS):
        self.topi, self.drops, self.replaced = [], [], []
        self._replay = None if replay is None else iter(replay)
        self.tie_ulps = tie_ulps

    def route(self, params, x, topw, topi):
        if self._replay is not None:
            want = torch.as_tensor(next(self._replay)).to(topi.device,
                                                          topi.dtype)
            diff = topi != want
            n = int(diff.sum())
            if n:
                logits = (x.to(BF16) @ params["router"].to(BF16)).to(F32)
                got, rec = logits.gather(-1, topi), logits.gather(-1, want)
                # ulps of the token's largest |logit|: the scale at which
                # two runs' sums drift apart
                mag = logits.abs().amax(-1, keepdim=True).clamp_min(1e-30)
                ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
                gap = ((got - rec).abs() / ulp)[diff].max().item()
                if gap > self.tie_ulps:
                    raise RuntimeError(
                        f"routing differs from the replayed run at {n} "
                        f"positions, router logits up to {gap:.1f} bf16 "
                        f"ulps apart: not a near tie "
                        f"(<= {self.tie_ulps} ulps)")
                w = torch.softmax(logits, dim=-1).gather(-1, want)
                topw = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
                topi = want
            self.replaced.append(n)
        self.topi.append(topi)
        return topw, topi


def dropped_share(drops) -> float:
    """Dropped assignments over all assignments of ``drops`` (some of a
    ``RoutingLog.drops``)."""
    total = sum(a for a, _ in drops)
    return sum(int(d) for _, d in drops) / max(total, 1)


_LOG: RoutingLog | None = None


@contextlib.contextmanager
def log_routing(replay=None, tie_ulps: float = NEAR_TIE_ULPS):
    """Open a :class:`RoutingLog` for the block (``replay``: another
    run's ``RoutingLog.topi``; ``tie_ulps``: the near-tie bound); yields
    it."""
    global _LOG
    saved, _LOG = _LOG, RoutingLog(replay, tie_ulps)
    try:
        yield _LOG
    finally:
        _LOG = saved
