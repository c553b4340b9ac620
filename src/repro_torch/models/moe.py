"""Mixture-of-Experts layer: top-k routing and the capacity dispatch, on
one card and expert-parallel across a mesh's ``model`` axis.

The PyTorch counterpart of the JAX package's ``models/moe.py``.  The JAX
``moe_layer`` on a mesh runs ``moe_layer_ep``: the router on the whole
batch, then a ``shard_map`` body per (data, model) shard; its serve and
train CLIs build a mesh even on one device, so one card runs that body at
one model shard.  :func:`moe_layer` computes those bodies:

* ``_ep_shard`` (``cfg.moe_impl='psum'``): the shard's tokens, replicated
  over ``model``; the shard holds experts [lo, lo + E/n_model).  Each
  assignment's rank within its expert counts the earlier assignments to
  that expert in token-major order (stable arrival order); ``keep =
  in_range & rank < C`` with C = ``capacity`` of the shard's **local**
  tokens, so what is dropped depends on the mesh.  The kept slots ``e C +
  rank`` are unique, so the pack into [E_l, C, d] is a copy; the grouped
  SwiGLU is three bf16 ``torch.bmm``; a token's k weighted results are
  added in order in bf16, rounded after each add, as the JAX scatter-add
  into a bf16 buffer does; the partial outputs are summed over ``model``
  (a bf16 psum);
* ``_ep_a2a_shard`` (``'a2a'``, where the sequence splits over
  ``model``): the shard's own sequence slice; assignments packed by
  destination shard into ``C_send`` slots each, exchanged (an
  all-to-all with the local expert ids beside them), packed again by
  local expert into ``C_exp`` slots at the receiver, computed, and sent
  back by a third exchange; the slices are gathered over ``model``.

At one model shard both bodies keep the same assignments and compute the
same output (the send side keeps all T k assignments, cf >= 1).  The
expert weights arrive as the rank's shards [E_l, d / |data|, f] and are
gathered over ``data`` in bf16 (FSDP); the gradient of that gather is a
bf16 reduce-scatter.  The router's aux loss takes its means over the
**global** batch (a psum over the data axes), as the JAX router computes
it outside the ``shard_map``.  Collectives are differentiable
(``distributed/collectives.py``).

The gather of each token's row for its k assignments has its own
backward (:class:`RepeatRows`): the k cotangents are added in assignment
order in bf16, as the VJP of the JAX gather ``xt[tok]`` adds them.  A
dropped assignment lands on the pack's dump row, which is cut away, so its
cotangent is 0, and its combine weight is 0, so its router weight gets no
gradient.

:func:`moe_layer_dense` is the dense oracle (every expert on every token,
no drop), the plain version the tests hold the dispatch against, and the
JAX package's fallback where the experts do not divide the ``model`` axis.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as tF

from repro_torch.distributed import collectives as coll
from repro_torch.launch.mesh import axis_group, axis_sizes, coordinate
from repro_torch.models.layers import BF16, F32, init_dense, init_mlp, mlp

# router logits within this many bf16 ulps of each other are a near tie
# (see RoutingLog.route): what a few layers of bf16 residual stream move
# them apart when two runs sum in different orders
NEAR_TIE_ULPS = 2
MODEL_AXIS = "model"


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


def router_topk(params, x, cfg, dp_group=None):
    """Top-k routing probabilities.  Returns (weights [B,S,k] f32, idx
    [B,S,k] int64, aux_loss f32 scalar): the logits are a bf16 product
    cast to f32, the weights renormalised over the k, aux the standard
    load-balancing loss E * sum_i f_i p_i over the batch — with
    ``dp_group``, the global batch: the means are psums over the group
    (the rank's batch one of equal shards).  An open :class:`RoutingLog`
    sees (and may replay) the indices before aux counts them."""
    logits = (x.to(BF16) @ params["router"].to(BF16)).to(F32)
    probs = torch.softmax(logits, dim=-1)                        # [B,S,E]
    topw, topi = top_k(probs, cfg.top_k)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    if _LOG is not None:
        topw, topi = _LOG.route(params, x, topw, topi)
    E = cfg.n_experts
    onehot = tF.one_hot(topi, E).to(F32).sum(-2)                  # [B,S,E]
    if coll.size(dp_group) == 1:
        f = onehot.mean((0, 1)) / cfg.top_k
        p_mean = probs.mean((0, 1))
    else:
        n = x.shape[0] * x.shape[1] * coll.size(dp_group)
        f = coll.all_reduce_sum(onehot.sum((0, 1)), dp_group) / n \
            / cfg.top_k
        p_mean = coll.psum(probs.sum((0, 1)), dp_group) / n
    aux = E * torch.sum(f * p_mean)
    return topw, topi, aux


def capacity(tokens: int, cfg) -> int:
    """Slots per expert for ``tokens`` tokens: tokens k cf / E rounded up
    to a multiple of 8, at least 8 (the JAX package's ``_capacity``)."""
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def arrival_rank(keys: torch.Tensor) -> torch.Tensor:
    """Each entry's rank among the entries of its key in order (the JAX
    code's cumsum of a one-hot): a stable sort and ``searchsorted``."""
    sorted_k, order = torch.sort(keys, stable=True)
    first = torch.searchsorted(sorted_k, sorted_k)   # key's first place
    rank = torch.empty_like(keys)
    rank[order] = torch.arange(keys.numel(), device=keys.device) - first
    return rank


def dispatch_slots(topi: torch.Tensor, cfg, lo: int = 0,
                   n_local: int | None = None):
    """The capacity dispatch of the A = T k assignments ``topi`` [..., k]
    holds, in token-major order, on the shard holding experts [lo, lo +
    n_local) (all E by default): (keep [A] bool, slot [A] int64, C).  A
    kept assignment's slot is ``(e - lo) C + rank``, its rank within
    expert e in arrival order; any other's (dropped, or another shard's
    expert) is n_local C (out of range)."""
    ek = topi.reshape(-1).long()
    E_l = cfg.n_experts if n_local is None else n_local
    C = capacity(ek.numel() // cfg.top_k, cfg)
    e_loc, rank = ek - lo, arrival_rank(ek)
    keep = (e_loc >= 0) & (e_loc < E_l) & (rank < C)
    slot = torch.where(keep, e_loc * C + rank, torch.full_like(ek, E_l * C))
    return keep, slot, C


class RepeatRows(torch.autograd.Function):
    """x [T, d] -> [T k, d], each row k times (the dispatch's gather of a
    token's row for its k assignments).  The backward adds a token's k
    cotangents in assignment order in x's type, rounding after each add,
    as the JAX VJP's scatter-add into x's cotangent does."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return x.repeat_interleave(k, dim=0)

    @staticmethod
    def backward(ctx, g):
        g = g.view(-1, ctx.k, g.shape[-1])
        out = g[:, 0].clone()
        for j in range(1, ctx.k):
            out = out + g[:, j]
        return out, None


def _swiglu_experts(buf, w_gate, w_up, w_down):
    """The grouped SwiGLU over [E_l, C, d] bf16 slots: three bf16 bmm."""
    g = torch.bmm(buf, w_gate.to(BF16))
    u = torch.bmm(buf, w_up.to(BF16))
    h = tF.silu(g.to(F32)).to(BF16) * u
    return torch.bmm(h, w_down.to(BF16))


def _pack(rows, slot, n_slots):
    """rows [A, d] copied to their slots of a [n_slots, d] bf16 buffer;
    the rows whose slot is n_slots land on a dump row that is cut away."""
    buf = torch.zeros((n_slots + 1, rows.shape[1]), dtype=BF16,
                      device=rows.device)
    buf.index_copy_(0, slot, rows)
    return buf[:n_slots]


def _combine(vals, T, k, d):
    """A token's k weighted results [T k, d] added in assignment order in
    bf16."""
    vals = vals.view(T, k, d)
    y = torch.zeros((T, d), dtype=BF16, device=vals.device)
    for j in range(k):
        y = y + vals[:, j]
    return y


def _ep_shard(x, topw, topi, w_gate, w_up, w_down, cfg, n_model: int,
              shard: int, group):
    """The psum body: x [b,S,d] the rank's tokens (replicated over
    ``model``), w_* [E_l, d, f] this shard's experts (gathered)."""
    b, S, d = x.shape
    T, k = b * S, cfg.top_k
    E_l = cfg.n_experts // n_model
    keep, slot, C = dispatch_slots(topi, cfg, lo=shard * E_l, n_local=E_l)
    if _LOG is not None:      # the assignments to this shard's experts
        owned = (topi.reshape(-1) // E_l) == shard
        _LOG.record_drops(T * k if n_model == 1 else owned.sum(),
                          (owned & ~keep).sum())
    rows = RepeatRows.apply(x.reshape(T, d), k).to(BF16)
    buf = _pack(rows, slot, E_l * C).view(E_l, C, d)
    y_buf = _swiglu_experts(buf, w_gate, w_up, w_down).reshape(E_l * C, d)
    # each token's k results weighted (another shard's expert or a dropped
    # one by 0), added in assignment order in bf16, then over the shards
    w = (topw.to(x.dtype).reshape(T * k) * keep).to(BF16)
    vals = y_buf[slot.clamp(max=E_l * C - 1)] * w[:, None]
    y = coll.psum(_combine(vals, T, k, d), group)
    return y.view(b, S, d)


def _ep_a2a_shard(x, topw, topi, w_gate, w_up, w_down, cfg, n_model: int,
                  group):
    """The all-to-all body: x [b,S_l,d] the rank's sequence slice, w_*
    [E_l, d, f] this shard's experts (gathered)."""
    b, S_l, d = x.shape
    T, E, k = b * S_l, cfg.n_experts, cfg.top_k
    E_l = E // n_model
    wk = topw.to(x.dtype).reshape(T * k)
    ek = topi.reshape(T * k).long()

    # ---- send side: pack assignments by destination shard ---------------
    dest = ek // E_l
    c = int(T * k * cfg.capacity_factor / n_model)   # per-destination slots
    C_send = max(8, ((c + 7) // 8) * 8)
    rank_d = arrival_rank(dest)
    keep = rank_d < C_send
    slot = torch.where(keep, dest * C_send + rank_d,
                       torch.full_like(dest, n_model * C_send))
    rows = RepeatRows.apply(x.reshape(T, d), k).to(BF16)
    send_x = _pack(rows, slot, n_model * C_send)
    # payload metadata: local expert id at the destination (E_l = empty)
    send_e = torch.full((n_model * C_send + 1,), E_l, dtype=torch.long,
                        device=x.device)
    send_e[slot] = torch.where(keep, ek % E_l, torch.full_like(ek, E_l))
    rx = coll.exchange(send_x, group)                    # [R, d]
    re = coll.all_to_all(send_e[:n_model * C_send], group)

    # ---- receiver: pack by local expert, grouped matmul ------------------
    C_exp = capacity(T * n_model, cfg)
    rank_e = arrival_rank(re)
    ok = (re < E_l) & (rank_e < C_exp)
    eslot = torch.where(ok, re * C_exp + rank_e,
                        torch.full_like(re, E_l * C_exp))
    if _LOG is not None:
        _LOG.record_drops(T * k, (~keep).sum() + ((re < E_l) & ~ok).sum())
    buf = _pack(rx, eslot, E_l * C_exp).view(E_l, C_exp, d)
    y_buf = _swiglu_experts(buf, w_gate, w_up, w_down).reshape(E_l * C_exp,
                                                               d)

    # ---- route results back ----------------------------------------------
    y_recv = y_buf[eslot.clamp(max=E_l * C_exp - 1)] * ok[:, None]
    y_send = coll.exchange(y_recv, group)
    vals = y_send[slot.clamp(max=n_model * C_send - 1)] \
        * (wk * keep).to(BF16)[:, None]
    return _combine(vals, T, k, d).view(b, S_l, d)


def _mesh_groups(mesh, data_axes):
    """(n_model, this rank's model index, model group, data group, data
    axes group) on ``mesh``; one card's at mesh None."""
    if mesh is None or mesh.size() == 1:
        return 1, 0, None, None, None
    n_model = axis_sizes(mesh).get(MODEL_AXIS, 1)
    return (n_model, coordinate(mesh).get(MODEL_AXIS, 0),
            axis_group(mesh, MODEL_AXIS), axis_group(mesh, "data"),
            axis_group(mesh, data_axes))


def moe_layer(params, x, cfg, mesh=None, data_axes: tuple = ("data",),
              global_aux: bool = True):
    """The moe layer: x [B,S,d] (the rank's batch shard on a mesh) ->
    (y [B,S,d] in x.dtype, aux).  With ``mesh`` None (one card, the JAX
    package's one-device mesh) or a mesh whose ``model`` axis divides the
    experts, the expert-parallel body ``cfg.moe_impl`` names (the a2a body
    where the sequence splits over ``model``); on a mesh, ``params``'s
    expert leaves are the rank's shards [E_l, d / |data|, f] ([E_l, f, d /
    |data|] for w_down).  Otherwise the dense oracle, as the JAX package
    falls back.  ``global_aux`` False (serving, which discards aux, as
    the JAX program drops it unused): aux over the rank's rows, with no
    collective."""
    n_model, m, model_g, data_g, dp_g = _mesh_groups(mesh, data_axes)
    if not global_aux:
        dp_g = None
    if cfg.n_experts % n_model:
        return moe_layer_dense(params, x, cfg, dp_g)
    topw, topi, aux = router_topk(params, x, cfg, dp_g)
    w_gate, w_up, w_down = (params[n].to(BF16)
                            for n in ("w_gate", "w_up", "w_down"))
    # FSDP: this layer's expert weights gathered over 'data' in bf16 (its
    # adjoint a bf16 reduce-scatter); replicated over 'pod'
    w_gate = coll.gather(w_gate, 1, data_g)
    w_up = coll.gather(w_up, 1, data_g)
    w_down = coll.gather(w_down, 2, data_g)
    S = x.shape[1]
    if cfg.moe_impl == "a2a" and S % n_model == 0:
        # tokens sequence-sharded over the model axis inside the layer
        sl = slice(m * (S // n_model), (m + 1) * (S // n_model))
        y = _ep_a2a_shard(x[:, sl], topw[:, sl], topi[:, sl], w_gate, w_up,
                          w_down, cfg, n_model, model_g)
        y = coll.gather(y, 1, model_g)
    else:
        y = _ep_shard(x, topw, topi, w_gate, w_up, w_down, cfg, n_model, m,
                      model_g)
    y = y.to(x.dtype)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], x)
    return y, aux


def moe_layer_dense(params, x, cfg, dp_group=None):
    """Dense oracle: every expert on every token, combined by gate (no
    capacity, no drop).  O(E) compute — the tests' plain version, and the
    layer where the experts do not divide the ``model`` axis."""
    topw, topi, aux = router_topk(params, x, cfg, dp_group)
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
    """The routing of every :func:`moe_layer` call of a forward while the
    log is open (:func:`log_routing`): each call's top-k indices [B,S,k]
    (``topi``) and its (assignments, dropped at capacity) pair, the
    second a 0-d device tensor (``drops``).  Recording syncs nothing with
    the host.

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

    A layer that remat reruns in the backward (``transformer._maybe_remat``
    under :func:`remat_contexts`) routes again as call ``calls`` of its
    forward did, and records nothing.
    """

    def __init__(self, replay=None, tie_ulps: float = NEAR_TIE_ULPS):
        self.topi, self.drops, self.replaced = [], [], []
        self._replay = None if replay is None else list(replay)
        self.tie_ulps = tie_ulps
        self.calls = 0          # moe calls of the forward so far
        self.rerun = False      # inside a remat rerun

    def route(self, params, x, topw, topi):
        if self._replay is not None:
            want = torch.as_tensor(self._replay[self.calls]).to(topi.device,
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
            if not self.rerun:
                self.replaced.append(n)
        if not self.rerun:
            self.topi.append(topi)
        self.calls += 1
        return topw, topi

    def record_drops(self, assignments, dropped):
        if not self.rerun:
            self.drops.append((assignments, dropped))


def dropped_share(drops) -> float:
    """Dropped assignments over all assignments of ``drops`` (some of a
    ``RoutingLog.drops``)."""
    total = sum(int(a) for a, _ in drops)
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


def remat_contexts():
    """``torch.utils.checkpoint``'s ``context_fn`` for a layer body: the
    forward notes the open log's call count, the rerun in the backward
    routes from that count with the log open again (whether or not the
    block that opened it has ended) and records nothing."""
    log = _LOG
    if log is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    at = []

    @contextlib.contextmanager
    def forward():
        at.append(log.calls)
        yield

    @contextlib.contextmanager
    def rerun():
        global _LOG
        saved = _LOG, log.calls, log.rerun
        _LOG, log.calls, log.rerun = log, at[0], True
        try:
            yield
        finally:
            _LOG, log.calls, log.rerun = saved

    return forward(), rerun()
