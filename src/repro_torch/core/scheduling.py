"""Container scheduling module (paper §3.5) — branch-free scoring, in PyTorch.

Counterpart of ``repro.core.scheduling``.  A scheduling algorithm IS a
weight vector: selection ranks containers by ``priority = sel_features @ w``
(:func:`rank_key`), placement takes the argmin over feasible hosts of
``placement_features(h) @ w`` (:func:`host_row`), and migration fires on
the ``W_MIG_ENABLE`` mask weight with a destination scored by
``migration_features(h) @ w``.  The six built-in policies are registered
as the JAX package's weight vectors, so a policy name means the same thing
in both packages.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import network
from repro_torch.core.datacenter import SimConfig
from repro_torch.core.types import (
    NUM_MIG_FEATURES, NUM_POLICY_WEIGHTS, NUM_ROW_FEATURES,
    STATUS_COMMUNICATING, STATUS_INACTIVE, STATUS_MIGRATING, STATUS_RUNNING,
    STATUS_WAITING, W_MIG0, W_MIG_ENABLE, W_ROW0, W_RR_TRACK, W_SEL_DURATION,
    W_SEL_SUBMIT, WEIGHT_NAMES, PolicyParams, RunParams, SimState,
    resolve_device, take,
)

BIG = 1e18               # host-score sentinel (infeasible)
INT_BIG = 2**31 - 1      # selection-key sentinel (unschedulable)
F32 = torch.float32
I32 = torch.int32


# ---------------------------------------------------------------------------
# Shared predicates
# ---------------------------------------------------------------------------
def feasible_hosts(cap: torch.Tensor, used: torch.Tensor, ncont: torch.Tensor,
                   req: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Hosts with resource headroom for ``req`` and a free container slot."""
    fits = ((used + req[None, :]) <= cap).all(dim=1)
    return fits & (ncont < cfg.max_containers_per_host)


def deployed_mask(ct) -> torch.Tensor:
    """Containers placed on a host: running, communicating or migrating."""
    st = ct.status
    return (((st == STATUS_RUNNING) | (st == STATUS_COMMUNICATING)
             | (st == STATUS_MIGRATING)) & (ct.host >= 0))


def schedulable_mask(sim: SimState) -> torch.Tensor:
    """Containers eligible for (re)placement: submitted+unscheduled or
    waiting."""
    st = sim.containers.status
    arrived = sim.containers.submit_t <= sim.t
    return arrived & ((st == STATUS_INACTIVE) | (st == STATUS_WAITING))


def rank_key(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sortable i32 selection key: rank under lexicographic (values, index);
    slots outside ``mask`` get ``INT_BIG``.  The rank is the inverse of the
    stable sort permutation, computed by a second stable argsort."""
    order = torch.argsort(values, stable=True)
    rank = torch.argsort(order, stable=True).to(I32)
    return torch.where(mask, rank, INT_BIG)


def select_key_fifo(sim: SimState) -> torch.Tensor:
    """Paper default selection: earliest-submitted first, index tie-break."""
    return rank_key(sim.containers.submit_t, schedulable_mask(sim))


def first_true(order_key: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Index minimizing ``order_key`` among ``mask`` (first on ties); -1 if
    ``mask`` is empty.  A 0-d int64 tensor (no host sync)."""
    key = torch.where(mask, order_key, BIG)
    return torch.where(mask.any(), torch.argmin(key), -1)


# ---------------------------------------------------------------------------
# The placement carry
# ---------------------------------------------------------------------------
class PlaceCarry(NamedTuple):
    rr: torch.Tensor         # i32[]    Round's rotating last-used-host pointer
    counts: torch.Tensor     # f32[K,H] deployed same-job containers per host
    leafpeers: torch.Tensor  # f32[K,H] same-job peers on the host's own leaf


def same_job_host_counts(sim: SimState, cand: torch.Tensor) -> torch.Tensor:
    """[K, H] deployed same-job container count per host, per candidate:
    one segment sum of the deployed containers onto a [K*H] table keyed by
    (first candidate sharing the container's job, host), pad slot K*H.
    Counts are integers, so the sum is exact in any order."""
    H = sim.hosts.cap.shape[0]
    K = cand.shape[0]
    ct = sim.containers
    jobs_k = ct.job[cand]                                       # [K]
    eq = ct.job[:, None] == jobs_k[None, :]                     # [C, K]
    hit = eq.any(dim=1) & deployed_mask(ct)
    k_first = torch.argmax(eq.to(torch.uint8), dim=1)           # [C]
    hostc = torch.clamp(ct.host, 0, H - 1).long()
    seg = torch.where(hit, k_first * H + hostc, K * H)
    table = torch.zeros((K * H + 1,), dtype=F32, device=cand.device)
    # integer-valued f32 counts below 2**24: exact in any order of adds
    table.index_add_(0, seg, hit.to(F32))
    kk_first = torch.argmax((jobs_k[None, :] == jobs_k[:, None])
                            .to(torch.uint8), dim=1)
    return table[:K * H].reshape(K, H)[kk_first]


def _worst_fit_row(sim: SimState, used: torch.Tensor) -> torch.Tensor:
    """Most total normalized free resources first (lower key = better)."""
    free = (sim.hosts.cap - used) / torch.clamp(sim.hosts.cap, min=1e-6)
    return -((free[:, 0] + free[:, 1]) + free[:, 2])


def select_key(sim: SimState, pol: PolicyParams) -> torch.Tensor:
    """i32[C] selection ranks from the weighted container-priority score
    ``w[sel_submit] * submit_t + w[sel_duration] * duration``."""
    ct = sim.containers
    w = pol.weights
    priority = w[W_SEL_SUBMIT] * ct.submit_t + w[W_SEL_DURATION] * ct.duration
    return rank_key(priority, schedulable_mask(sim))


def init_place_carry(sim: SimState, cand: torch.Tensor,
                     pol: PolicyParams) -> PlaceCarry:
    """One carry for every policy: co-location counts, per-leaf peer
    totals and the persisted ``rr_pointer``."""
    counts = same_job_host_counts(sim, cand)                    # [K, H]
    leaf = sim.hosts.leaf.long()
    # integer-valued f32 counts below 2**24: exact in any order of adds
    per_leaf = torch.zeros_like(counts).index_add_(1, leaf, counts)
    return PlaceCarry(rr=sim.sched.rr_pointer, counts=counts,
                      leafpeers=per_leaf[:, leaf])


def _row_feature_columns(sim: SimState, cfg: SimConfig, params: RunParams,
                         carry: PlaceCarry, k: int, cand: torch.Tensor,
                         used: torch.Tensor) -> tuple:
    """The shared feature columns (``F_*`` order) for candidate ``k``; all
    finite, so a zero weight contributes an exact 0.0."""
    hosts = sim.hosts
    H = hosts.cap.shape[0]
    ct = sim.containers
    dev = used.device

    recency = torch.remainder(torch.arange(H, device=dev) - carry.rr - 1,
                              H).to(F32)
    neg_speed = -take(hosts.speed, take(ct.ctype, cand[k]), dim=1)
    free = (hosts.cap - used) / torch.clamp(hosts.cap, min=1e-6)   # [H, 3]
    worst = -((free[:, 0] + free[:, 1]) + free[:, 2])

    cnt = carry.counts[k]                                          # [H]
    total = cnt.sum()
    has = total > 0
    coloc = torch.where(has, -cnt, 0.0)
    # cnt @ comm_cost, accumulated over the source hosts in order
    comm = torch.where(has, (cnt[:, None] * sim.net.comm_cost).sum(0)
                       / torch.clamp(total, min=1.0), 0.0)
    fallback = torch.where(has, 0.0, worst)

    ratio = used / torch.clamp(hosts.cap, min=1e-6)
    host_util = torch.maximum(torch.maximum(ratio[:, 0], ratio[:, 1]),
                              ratio[:, 2])
    uplink = sim.net.link_util[:H]   # host i's access link is link i
    cross_leaf = torch.where(has, (total - carry.leafpeers[k])
                             / torch.clamp(total, min=1.0), 0.0)
    return (recency, neg_speed, worst, coloc, comm, fallback,
            host_util, free[:, 0], free[:, 1], uplink, cross_leaf)


def placement_features(sim: SimState, cfg: SimConfig, params: RunParams,
                       carry: PlaceCarry, k: int, cand: torch.Tensor,
                       used: torch.Tensor) -> torch.Tensor:
    """The [H, NUM_ROW_FEATURES] bank view of the feature columns."""
    return torch.stack(_row_feature_columns(sim, cfg, params, carry, k, cand,
                                            used), dim=1)


def host_row_cols(sim: SimState, cfg: SimConfig, params: RunParams,
                  pol: PolicyParams, carry: PlaceCarry, k: int,
                  cand: torch.Tensor, used: torch.Tensor) -> tuple:
    """:func:`host_row` plus the raw feature columns it was summed from."""
    cols = _row_feature_columns(sim, cfg, params, carry, k, cand, used)
    w = pol.weights
    score = cols[0] * w[W_ROW0]
    for i in range(1, NUM_ROW_FEATURES):
        score = score + cols[i] * w[W_ROW0 + i]
    return score, cols


def host_row(sim: SimState, cfg: SimConfig, params: RunParams,
             pol: PolicyParams, carry: PlaceCarry, k: int, cand: torch.Tensor,
             used: torch.Tensor) -> torch.Tensor:
    """Candidate ``k``'s f32[H] preference row (lower = better): the
    weighted sum of the feature columns, summed in ``F_*`` order.
    Feasibility is masked by the engine."""
    return host_row_cols(sim, cfg, params, pol, carry, k, cand, used)[0]


def update_place_carry(sim: SimState, pol: PolicyParams, carry: PlaceCarry,
                       k: int, cand: torch.Tensor, hh: torch.Tensor,
                       ok: torch.Tensor) -> PlaceCarry:
    """Admit bookkeeping after candidate ``k`` lands on ``hh``: the pointer
    follows the admit when ``W_RR_TRACK`` is set, and every same-job
    candidate gains one co-located peer on ``hh`` and one same-leaf peer on
    every host of ``hh``'s leaf."""
    track = pol.weights[W_RR_TRACK] > 0
    rr = torch.where(ok & track, hh.to(I32), carry.rr)
    job = sim.containers.job
    same = job[cand] == take(job, cand[k])
    H = carry.counts.shape[1]
    hot = (torch.arange(H, device=hh.device) == hh) & ok
    counts = torch.where(hot[None, :] & same[:, None],
                         carry.counts + 1.0, carry.counts)
    leaf = sim.hosts.leaf
    on_leaf = (leaf == take(leaf, hh)) & ok
    leafpeers = torch.where(on_leaf[None, :] & same[:, None],
                            carry.leafpeers + 1.0, carry.leafpeers)
    return PlaceCarry(rr=rr, counts=counts, leafpeers=leafpeers)


def commit_place_carry(sched, carry: PlaceCarry):
    """Persist the round's carry: only the rotating pointer outlives it."""
    return sched._replace(rr_pointer=carry.rr)


# ---------------------------------------------------------------------------
# Migration (paper §3.5 algorithm 1, DRAPS-derived)
# ---------------------------------------------------------------------------
def _overload_source(sim: SimState, cfg: SimConfig, params: RunParams):
    """Shared source/container selection: returns (src, cont, src_c,
    dst_mask) — the most over-threshold host (-1 none), its RUNNING
    container using the most of the host's bottleneck resource, and the
    feasible idle destinations."""
    util = sim.hosts.used / torch.clamp(sim.hosts.cap, min=1e-6)  # [H, 3]
    worst = util.amax(dim=1)
    overloaded = worst > params.overload_threshold
    H = worst.shape[0]
    src = first_true(-worst, overloaded)
    src_c = torch.clamp(src, 0, H - 1)
    bottleneck = torch.argmax(take(util, src_c))
    ct = sim.containers
    movable = (ct.status == STATUS_RUNNING) & (ct.host == src_c)
    usage = take(ct.req, bottleneck, dim=1)
    cont = first_true(-usage, movable)
    C = movable.shape[0]
    cont_c = torch.clamp(cont, 0, C - 1)

    feas = feasible_hosts(sim.hosts.cap, sim.hosts.used,
                          sim.hosts.n_containers, take(ct.req, cont_c), cfg)
    idle = (util < params.idle_threshold).all(dim=1)
    dst_mask = feas & idle & (torch.arange(H, device=util.device) != src_c)
    return src, cont, src_c, dst_mask


def migration_features(sim: SimState, src_c: torch.Tensor) -> torch.Tensor:
    """[H, NUM_MIG_FEATURES] destination bank (``M_*`` enum): host index,
    bottleneck path utilization from the source, cross-leaf indicator,
    worst fit."""
    H = sim.hosts.cap.shape[0]
    dev = sim.hosts.cap.device
    idx = torch.arange(H, dtype=F32, device=dev)
    putil = network.path_util_row(sim.net, src_c)
    leaf = sim.hosts.leaf
    cross = (leaf != take(leaf, src_c)).to(F32)
    return torch.stack([idx, putil, cross,
                        _worst_fit_row(sim, sim.hosts.used)], dim=1)


def migrate(sim: SimState, cfg: SimConfig, params: RunParams,
            pol: PolicyParams):
    """(container | -1, dst | -1) for this decision step; ``W_MIG_ENABLE``
    = 0 gives the no-op (-1, -1)."""
    w = pol.weights
    src, cont, src_c, dst_mask = _overload_source(sim, cfg, params)
    feats = migration_features(sim, src_c)
    mw = w[W_MIG0:W_MIG0 + NUM_MIG_FEATURES]
    score = feats[:, 0] * mw[0]
    for i in range(1, NUM_MIG_FEATURES):
        score = score + feats[:, i] * mw[i]
    dst = first_true(score, dst_mask)
    ok = (src >= 0) & (cont >= 0) & (dst >= 0) & (w[W_MIG_ENABLE] > 0)
    return torch.where(ok, cont, -1), torch.where(ok, dst, -1)


# ---------------------------------------------------------------------------
# Registry: name -> canonical weight vector (numpy; a PolicyParams is built
# on the requested device by get_policy)
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, np.ndarray] = {}


def weight_index(name: str) -> int:
    try:
        return WEIGHT_NAMES.index(name)
    except ValueError:
        raise KeyError(f"unknown weight {name!r}; known: "
                       f"{list(WEIGHT_NAMES)}") from None


def weight_vector(**overrides) -> np.ndarray:
    """A canonical-length weight vector by name, starting from the neutral
    defaults every built-in shares (FIFO selection, the comm-cost model
    weights)."""
    w = np.zeros(NUM_POLICY_WEIGHTS, np.float32)
    w[weight_index("util")] = network.DEFAULT_UTIL_WEIGHT
    w[weight_index("cross_leaf")] = network.DEFAULT_CROSS_LEAF_MS
    w[weight_index("sel_submit")] = 1.0
    for name, val in overrides.items():
        w[weight_index(name)] = val
    return w


def validate_weights(w, context: str = "") -> None:
    """Loud canonical-length check."""
    shape = tuple(np.shape(w))
    if len(shape) == 0 or shape[-1] != NUM_POLICY_WEIGHTS:
        raise ValueError(
            f"{context}weights must have the canonical length "
            f"{NUM_POLICY_WEIGHTS} (types.WEIGHT_NAMES), got shape {shape}")


def register(name: str, weights) -> np.ndarray:
    """Add (or replace, by name) a policy: a weight vector or a dict of
    by-name overrides.  The registry owns a copy."""
    if isinstance(weights, dict):
        weights = weight_vector(**weights)
    w = np.array(weights, np.float32)
    validate_weights(w, f"policy {name!r}: ")
    _REGISTRY[name] = w
    return w


def get_policy(name: str, weights=None, device=None) -> PolicyParams:
    """The data handle for a registered policy on ``device``; ``weights``
    overrides the registered vector (full vector or by-name dict)."""
    try:
        base = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; known: {sorted(_REGISTRY)}") from None
    if weights is None:
        w = base
    elif isinstance(weights, dict):
        w = base.copy()
        for k, v in weights.items():
            w[weight_index(k)] = v
    else:
        w = np.asarray(weights, np.float32)
        validate_weights(w, f"policy {name!r}: ")
    return PolicyParams(weights=torch.tensor(w, dtype=F32,
                                             device=resolve_device(device)))


def list_policies() -> list[str]:
    return sorted(_REGISTRY)


# The six built-ins (the JAX package's weight vectors).
register("firstfit", dict(row_recency=1.0))
register("round", dict(row_recency=1.0, rr_track=1.0))
register("performance_first", dict(row_neg_speed=1.0))
register("jobgroup", dict(row_coloc=1.0, row_fallback_worst=1.0))
register("netaware", dict(row_comm=1.0, row_fallback_worst=1.0,
                          mig_enable=1.0, mig_path_util=1.0))
register("overload_migrate", dict(row_recency=1.0, mig_enable=1.0,
                                  mig_idx=1.0))
