"""Discrete event driver module (paper §3.6), in PyTorch.

Counterpart of ``repro.core.engine`` for the main path.  The paper's eight
1-second SimPy processes form a synchronous time-stepped simulation; each
tick applies them as phase-ordered transitions on the state tensors:

    arrive -> schedule(+migrate decisions) -> flow rates -> communicate
           -> migrate(progress) -> execute(+comm triggers) -> complete
           -> cost -> delay-matrix refresh (every K ticks) -> stats

Where the JAX package has ``lax.scan`` this is a Python loop, and every
update is a masked tensor op on the state's device.  A tick reads back
from the device only what sets its loop lengths: the number of valid
placement candidates, the migration weight, and whether each migration
step started one (a 0-d tensor is never used as an index, which would
read it back too: ``types.take``); each read-back is a ``host_sync``
span of ``core/trace.py``, recorded while a profiler runs.  On a CUDA
device the admit round's candidate loop, the flow allocation and the
'fw' delay refresh go through the hand-written kernels
(``repro_torch.kernels``; :func:`make_tick_ext` asks
``kernels.kernel_route`` for each route once).  Float segment sums
(the requests a tick releases) add each segment's rows in row order on
every device, and the same sort's offsets count the containers, with no
read-back (``network.segment_sum_count``), so the card's sums equal the
CPU's; every entry point turns on
``torch.use_deterministic_algorithms`` (:func:`use_deterministic`) so
that no op of the tick takes an order that changes from run to run.
``run_sim`` stacks the per-tick metrics; with ``ExecPlan(chunk=...)`` it
streams them into a per-chunk accumulator (:func:`run_sim_chunked`), and
with ``ExecPlan(telescope=True)`` it advances quiescent intervals in
cheap ticks up to a closed-form event horizon
(:func:`simulate_telescoped`), the final state the per-tick run's bit for
bit; each of its decisions is a read-back to the host.
With ``SimConfig.soft_placement`` the schedule phase also sums a softmax
surrogate of its decisions (:func:`phase_schedule_soft`), which torch
autograd differentiates in the policy weights (``launch.sweep.make_grad_fn``);
the decisions, and so the run, are the same with the flag on or off.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.profiler import record_function

from repro_torch.core import network, scheduling, stats, trace, workload
from repro_torch.core.datacenter import SimConfig
from repro_torch.core.scheduling import BIG, INT_BIG, feasible_hosts
from repro_torch.core.types import (
    STATUS_COMMUNICATING, STATUS_COMPLETED, STATUS_INACTIVE, STATUS_MIGRATING,
    STATUS_RUNNING, STATUS_UNBORN, STATUS_WAITING, W_CROSS_LEAF, W_MIG_ENABLE,
    W_UTIL,
    ContainerState, ExecPlan, HostState, NetState, PolicyParams, RunParams,
    SchedState, SimState, SummaryAcc, TickMetrics, take,
)
from repro_torch.kernels import (fw_minplus, kernel_route, place_round,
                                 seg_waterfill)

I32 = torch.int32
F32 = torch.float32


# ---------------------------------------------------------------------------
# State assembly
# ---------------------------------------------------------------------------
def init_sim(hosts: HostState, containers: ContainerState,
             net: NetState) -> SimState:
    """The initial state on the device the inputs live on."""
    dev = hosts.cap.device
    return SimState(
        t=torch.zeros((), dtype=F32, device=dev),
        hosts=hosts,
        containers=containers,
        net=net,
        sched=SchedState(
            rr_pointer=torch.full((), -1, dtype=I32, device=dev),
            decisions=torch.zeros((), dtype=I32, device=dev),
            migrations=torch.zeros((), dtype=I32, device=dev)),
        total_cost=torch.zeros((), dtype=F32, device=dev),
    )


# ---------------------------------------------------------------------------
# Resource bookkeeping helpers (masked, safe for c == -1 / h == -1)
# ---------------------------------------------------------------------------
def _one_hot(n: int, idx: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """bool[n] mask selecting ``idx`` when ``ok``."""
    return (torch.arange(n, device=idx.device) == idx) & ok


def _deploy(sim: SimState, c: torch.Tensor, h: torch.Tensor) -> SimState:
    C = sim.containers.status.shape[0]
    H = sim.hosts.cap.shape[0]
    cc = torch.clamp(c, 0, C - 1)
    hh = torch.clamp(h, 0, H - 1)
    ok = (c >= 0) & (h >= 0)
    ct = sim.containers
    hot_h = _one_hot(H, hh, ok)
    hot_c = _one_hot(C, cc, ok)
    req = take(ct.req, cc)
    hosts = sim.hosts._replace(
        used=torch.where(hot_h[:, None], sim.hosts.used + req[None, :],
                         sim.hosts.used),
        n_containers=torch.where(hot_h, sim.hosts.n_containers + 1,
                                 sim.hosts.n_containers),
    )
    conts = ct._replace(
        status=torch.where(hot_c, STATUS_RUNNING, ct.status),
        host=torch.where(hot_c, hh.to(I32), ct.host),
        start_t=torch.where(hot_c & (ct.start_t < 0), sim.t, ct.start_t),
        retry=torch.where(hot_c, 0, ct.retry),
    )
    return sim._replace(hosts=hosts, containers=conts)


def _free_resources(hosts: HostState, req: torch.Tensor,
                    host_idx: torch.Tensor, mask: torch.Tensor) -> HostState:
    """Release ``req[c]`` on ``host_idx[c]`` where ``mask``: per-host totals
    and counts from one segment sum (the unmasked rows take the pad id H,
    which the sum drops; each host's rows added in container order on
    every device, its count the length of its segment,
    ``network.segment_sum_count``), subtracted in one pass, with no
    read-back.  Under a profiler the span ``free_resources``
    (``core/trace.py``)."""
    with trace.span("free_resources"):
        H = hosts.cap.shape[0]
        m = mask & (host_idx >= 0)
        seg = torch.where(m, host_idx, H).long()
        dreq, dcnt = network.segment_sum_count(req, seg, H)
        return hosts._replace(
            used=hosts.used - dreq,
            n_containers=hosts.n_containers - dcnt.to(I32))


# ---------------------------------------------------------------------------
# Tick phases
# ---------------------------------------------------------------------------
def phase_arrive(sim: SimState) -> Tuple[SimState, torch.Tensor]:
    """UNBORN -> INACTIVE once submit_t <= t (generate_containers)."""
    ct = sim.containers
    arriving = (ct.status == STATUS_UNBORN) & (ct.submit_t <= sim.t)
    status = torch.where(arriving, STATUS_INACTIVE, ct.status)
    return (sim._replace(containers=ct._replace(status=status)),
            arriving.sum().to(I32))


def _pick_host(row: torch.Tensor, feas: torch.Tensor) -> torch.Tensor:
    """Argmin of a candidate's [H] preference row over the feasible hosts
    (-1 when none is feasible)."""
    return torch.where(feas.any(),
                       torch.argmin(torch.where(feas, row, BIG)), -1)


def _place_sequential(sim: SimState, cfg: SimConfig, params: RunParams,
                      policy: PolicyParams) -> SimState:
    """Sequential reference path: each step is a K=1 placement round
    against the live state (an infeasible head blocks the rest, the
    paper's semantics)."""
    H = sim.hosts.cap.shape[0]
    for _ in range(cfg.placements_per_tick):
        key = scheduling.select_key(sim, policy)
        c = torch.argmin(key)
        valid = take(key, c) < INT_BIG
        cand = c[None]
        pcarry = scheduling.init_place_carry(sim, cand, policy)
        feas = feasible_hosts(sim.hosts.cap, sim.hosts.used,
                              sim.hosts.n_containers,
                              take(sim.containers.req, c),
                              cfg) & valid
        h = _pick_host(scheduling.host_row(sim, cfg, params, policy, pcarry,
                                           0, cand, sim.hosts.used), feas)
        ok = h >= 0
        hh = torch.clamp(h, 0, H - 1)
        pcarry = scheduling.update_place_carry(sim, policy, pcarry, 0, cand,
                                               hh, ok)
        sim = sim._replace(sched=scheduling.commit_place_carry(sim.sched,
                                                               pcarry))
        sim = _deploy(sim, torch.where(valid, c, -1), h)
        sim = sim._replace(sched=sim.sched._replace(
            decisions=sim.sched.decisions + ok.to(I32)))
    return sim


def _scatter_to_containers(C: int, idx: torch.Tensor, ok: torch.Tensor):
    """Map a round's distinct per-decision indices onto the container axis:
    ``sel[c]`` marks containers hit by an admitted decision and
    ``slot_of[c]`` is the decision slot that hit them."""
    hit = ((idx[None, :] == torch.arange(C, device=idx.device)[:, None])
           & ok[None, :])                                          # [C, K]
    return hit.any(dim=1), torch.argmax(hit.to(torch.uint8), dim=1)


def _admit_candidates(sim: SimState, cfg: SimConfig, policy: PolicyParams):
    """The admit round's candidates: ``(cand i64[K], valid bool[K], req_k
    f32[K, 3], the placement carry)``, the K = ``placements_per_tick``
    smallest selection keys in key order."""
    C = sim.containers.status.shape[0]
    K = min(cfg.placements_per_tick, C)
    key = scheduling.select_key(sim, policy)                 # i32[C]
    # keys are distinct ranks except the INT_BIG fill; giving the fill
    # C + index makes every key distinct, so topk picks the JAX package's
    # lax.top_k candidates (lowest index first on the fill) in its order
    arange_c = torch.arange(C, device=sim.t.device)
    distinct = torch.where(key < INT_BIG, key.long(), C + arange_c)
    cand = torch.topk(distinct, K, largest=False, sorted=True).indices
    valid = key[cand] < INT_BIG                              # bool[K]
    req_k = sim.containers.req[cand]                         # [K, 3]
    return cand, valid, req_k, scheduling.init_place_carry(sim, cand, policy)


def _place_batched(sim: SimState, cfg: SimConfig, params: RunParams,
                   policy: PolicyParams):
    """Batched conflict-resolved placement round.

    Rank the schedulable containers once by the selection key, take the
    K = ``placements_per_tick`` smallest keys, and admit them in order with
    a K-step loop carrying the live host ``used``/slot counters and the
    placement carry, so later decisions see earlier ones; then apply the
    container updates in one masked pass.  A candidate with no feasible
    host is skipped instead of blocking the round.  The loop is
    ``kernels.place_round``: one launch of its CUDA kernel on the card,
    its plain version on the CPU and with ``cfg.soft_placement``, whose
    surrogate autograd differentiates through the loop.

    Returns ``(sim', soft)``.  With ``cfg.soft_placement`` the loop also
    sums the surrogate ``soft = (soft_comm, soft_util, soft_n)``: the
    expected comm and host-util columns under
    ``scheduling.soft_assign`` of the row the argmin takes, and the count
    of candidates with a feasible host.  The decisions are the same
    either way; with the flag off ``soft`` is None.
    """
    C = sim.containers.status.shape[0]
    H = sim.hosts.cap.shape[0]
    cand, valid, req_k, pcarry = _admit_candidates(sim, cfg, policy)
    # valid candidates come first in key order, and an invalid one admits
    # nothing and leaves the carry as it was, so the loop stops at the
    # last valid candidate (one read of the count from the device per
    # tick)
    with trace.host_sync("admit_count"):
        n_valid = int(valid.sum())
    trace.count("candidates", n_valid)
    # looked up in the kernel's package on every round
    if cfg.soft_placement:
        rnd = place_round.place_round_ref(sim, cfg, params, policy, cand,
                                          valid, req_k, pcarry, n_valid,
                                          soft=True)
    else:
        rnd = place_round.place_round(sim, cfg, params, policy, cand, valid,
                                      req_k, pcarry, n_valid)
    chosen = rnd.chosen

    ok = chosen >= 0
    hh = torch.clamp(chosen, 0, H - 1).to(I32)
    ct = sim.containers
    sel, k_of = _scatter_to_containers(C, cand, ok)
    conts = ct._replace(
        status=torch.where(sel, STATUS_RUNNING, ct.status),
        host=torch.where(sel, hh[k_of], ct.host),
        start_t=torch.where(sel & (ct.start_t < 0), sim.t, ct.start_t),
        retry=torch.where(sel, 0, ct.retry),
    )
    hosts = sim.hosts._replace(used=rnd.used, n_containers=rnd.ncont)
    sched = scheduling.commit_place_carry(sim.sched, rnd.carry)._replace(
        decisions=sim.sched.decisions + ok.sum().to(I32))
    return (sim._replace(hosts=hosts, containers=conts, sched=sched),
            rnd.soft)


def _migrate_batched(sim: SimState, cfg: SimConfig, params: RunParams,
                     policy: PolicyParams):
    """Migration decision round: ``migrations_per_tick`` decision steps
    carrying only what a migration start changes (host counters, container
    status), then one masked pass applying the chosen (container,
    destination) pairs.  A policy whose ``W_MIG_ENABLE`` is zero leaves the
    state untouched.

    Returns ``(sim', soft)``: with ``cfg.soft_placement`` the steps also
    sum ``scheduling.migrate_soft``'s ``(soft_mig, soft_mig_n)`` (the
    decisions unchanged), else ``soft`` is None."""
    C = sim.containers.status.shape[0]
    H = sim.hosts.cap.shape[0]
    used, ncont = sim.hosts.used, sim.hosts.n_containers
    status = sim.containers.status
    minus1 = torch.full((), -1, dtype=torch.int64, device=status.device)
    cs = [minus1] * cfg.migrations_per_tick
    dsts = [minus1] * cfg.migrations_per_tick
    # a step that starts no migration leaves the state it reads unchanged,
    # so every later step would decide the same: the round stops there
    # (and never starts for a policy whose W_MIG_ENABLE weight is zero).
    # Such a step adds an exact 0.0 to both soft sums, so they equal the
    # JAX package's sums over every step.
    soft_on = cfg.soft_placement
    if soft_on:
        s_mig = s_mig_n = torch.zeros((), dtype=F32, device=status.device)
    with trace.host_sync("mig_enabled"):
        enabled = bool(policy.weights[W_MIG_ENABLE] > 0)
    for i in range(cfg.migrations_per_tick if enabled else 0):
        view = sim._replace(
            hosts=sim.hosts._replace(used=used, n_containers=ncont),
            containers=sim.containers._replace(status=status))
        if soft_on:
            c, dst, sv, sc = scheduling.migrate_soft(view, cfg, params,
                                                     policy)
            s_mig, s_mig_n = s_mig + sv, s_mig_n + sc
        else:
            c, dst = scheduling.migrate(view, cfg, params, policy)
        ok = (c >= 0) & (dst >= 0)
        cc = torch.clamp(c, 0, C - 1)
        hh = torch.clamp(dst, 0, H - 1)
        # reserve destination resources for the duration of the transfer
        hot_h = _one_hot(H, hh, ok)
        used = torch.where(hot_h[:, None],
                           used + take(sim.containers.req, cc)[None, :],
                           used)
        ncont = torch.where(hot_h, ncont + 1, ncont)
        status = torch.where(_one_hot(C, cc, ok), STATUS_MIGRATING, status)
        cs[i] = torch.where(ok, cc, -1)
        dsts[i] = torch.where(ok, hh, -1)
        with trace.host_sync("mig_step"):
            stop = not bool(ok)
        if stop:
            break
    cs = torch.stack(cs)
    dsts = torch.stack(dsts).to(I32)

    ok = cs >= 0
    # chosen containers are distinct (MIGRATING leaves the movable set)
    sel, m_of = _scatter_to_containers(C, cs, ok)
    ct = sim.containers
    conts = ct._replace(
        status=status,
        mig_dst=torch.where(sel, dsts[m_of], ct.mig_dst),
        mig_bytes_left=torch.where(sel, cfg.mig_kb_per_gb * ct.req[:, 1],
                                   ct.mig_bytes_left),
        retry=torch.where(sel, 0, ct.retry),
    )
    hosts = sim.hosts._replace(used=used, n_containers=ncont)
    sched = sim.sched._replace(
        migrations=sim.sched.migrations + ok.sum().to(I32))
    return (sim._replace(hosts=hosts, containers=conts, sched=sched),
            (s_mig, s_mig_n) if soft_on else None)


def phase_schedule_soft(sim: SimState, cfg: SimConfig, policy: PolicyParams,
                        params: RunParams | None = None):
    """:func:`phase_schedule` plus the tick's surrogate terms: ``(sim',
    (soft_comm, soft_util, soft_n, soft_mig, soft_mig_n))``, all 0.0
    unless ``cfg.soft_placement``.  The state transition is the same
    either way."""
    if cfg.soft_placement and not cfg.batched_placement:
        raise ValueError(
            "SimConfig.soft_placement requires batched_placement: the "
            "sequential reference path has no admit round to relax")
    params = cfg.run_params(sim.t.device) if params is None else params
    zero = torch.zeros((), dtype=I32, device=sim.t.device)
    sim = sim._replace(sched=sim.sched._replace(decisions=zero,
                                                migrations=zero))
    if cfg.batched_placement:
        with trace.span("admit_round"):
            sim, place_soft = _place_batched(sim, cfg, params, policy)
    else:
        sim, place_soft = _place_sequential(sim, cfg, params, policy), None
    sim, mig_soft = _migrate_batched(sim, cfg, params, policy)
    if place_soft is None:
        return sim, (torch.zeros((), dtype=F32, device=sim.t.device),) * 5
    return sim, place_soft + mig_soft


def phase_schedule(sim: SimState, cfg: SimConfig, policy: PolicyParams,
                   params: RunParams | None = None) -> SimState:
    """Paper ``schedule`` process: place up to ``placements_per_tick``
    containers (batched round, or the sequential reference), then start up
    to ``migrations_per_tick`` migrations."""
    return phase_schedule_soft(sim, cfg, policy, params)[0]


def pick_comm_peers(ct: ContainerState) -> torch.Tensor:
    """Dependent-container peer: lowest-index *deployed* container of the
    same job (the second-lowest for that container itself); self when the
    container is its job's only deployed member.  Two segment minima over
    job ids (``scatter_reduce('amin')``), O(C)."""
    C = ct.status.shape[0]
    idx = torch.arange(C, device=ct.status.device)
    member = scheduling.deployed_mask(ct) & (ct.job >= 0)
    seg = torch.clamp(ct.job, 0, C - 1).long()

    def seg_min(key):
        return torch.full((C,), C, dtype=idx.dtype, device=idx.device) \
            .scatter_reduce(0, seg, key, reduce="amin", include_self=True)

    first = seg_min(torch.where(member, idx, C))[seg]
    is_first = member & (idx == first)
    second = seg_min(torch.where(member & ~is_first, idx, C))[seg]
    peer = torch.where(first == idx, second, first)
    has = (ct.job >= 0) & (peer < C)
    return torch.where(has, peer, idx).to(I32)


def pick_comm_peers_dense(ct: ContainerState) -> torch.Tensor:
    """O(C^2) reference implementation of :func:`pick_comm_peers`."""
    C = ct.status.shape[0]
    dev = ct.status.device
    same_job = (ct.job[:, None] == ct.job[None, :]) & (ct.job[:, None] >= 0)
    cand = (same_job & scheduling.deployed_mask(ct)[None, :]
            & ~torch.eye(C, dtype=torch.bool, device=dev))
    first = torch.argmax(cand.to(torch.uint8), dim=1)
    return torch.where(cand.any(dim=1), first,
                       torch.arange(C, device=dev)).to(I32)


def phase_flows(sim: SimState, cfg: SimConfig,
                allocate=network.waterfill_sparse):
    """This tick's flow rates (paper: iperf transfers).  Flow f in [0, C) is
    container f's communication flow, f in [C, 2C) its migration flow;
    ``allocate`` is the sparse allocation ``network.flow_rates`` calls.
    Returns (sim with the new link utilization, comm rates, migration
    rates, active mask [2C], rates [2C])."""
    ct = sim.containers
    C = ct.status.shape[0]
    comm_active = ct.status == STATUS_COMMUNICATING
    mig_active = ct.status == STATUS_MIGRATING
    peer = torch.clamp(ct.comm_peer, 0, C - 1).long()
    src = torch.cat([ct.host, ct.host])
    dst = torch.cat([ct.host[peer], ct.mig_dst])
    active = torch.cat([comm_active, mig_active])
    rates, util = network.flow_rates(sim.net, src, dst, active,
                                     n_rounds=cfg.waterfill_rounds,
                                     sparse=cfg.sparse_flows,
                                     allocate=allocate)
    sim = sim._replace(net=sim.net._replace(link_util=util))
    return sim, rates[:C], rates[C:], active, rates


def phase_communicate(sim: SimState, cfg: SimConfig,
                      comm_rates: torch.Tensor) -> SimState:
    """Progress communication flows; bounded retransmission -> WAITING."""
    ct = sim.containers
    comm = ct.status == STATUS_COMMUNICATING
    new_left = torch.where(comm, ct.comm_bytes_left - comm_rates,
                           ct.comm_bytes_left)
    done = comm & (new_left <= 0.0)
    stalled = comm & ~done & (comm_rates < cfg.stall_rate_floor)
    retry = torch.where(stalled, ct.retry + 1, torch.where(comm, 0, ct.retry))
    failed = stalled & (retry > cfg.max_retries)

    # failure: paper Table 2 — waiting is *undeployed*; back to the scheduler
    hosts = _free_resources(sim.hosts, ct.req, ct.host, failed)

    status = torch.where(done, STATUS_RUNNING, ct.status)
    status = torch.where(failed, STATUS_WAITING, status)
    conts = ct._replace(
        status=status,
        comm_bytes_left=torch.where(done | failed, 0.0,
                                    torch.clamp(new_left, min=0.0)),
        n_comms_left=torch.where(done, ct.n_comms_left - 1, ct.n_comms_left),
        next_comm_at=torch.where(done, ct.next_comm_at + ct.comm_work_gap,
                                 ct.next_comm_at),
        comm_peer=torch.where(done | failed, -1, ct.comm_peer),
        comm_time=ct.comm_time + comm.to(F32),
        retry=torch.where(failed, 0, retry),
        host=torch.where(failed, -1, ct.host),
    )
    return sim._replace(hosts=hosts, containers=conts)


def phase_migrate(sim: SimState, cfg: SimConfig,
                  mig_rates: torch.Tensor) -> SimState:
    """Progress migration flows: done -> switch host; stalled out ->
    WAITING."""
    ct = sim.containers
    mig = ct.status == STATUS_MIGRATING
    new_left = torch.where(mig, ct.mig_bytes_left - mig_rates,
                           ct.mig_bytes_left)
    done = mig & (new_left <= 0.0)
    stalled = mig & ~done & (mig_rates < cfg.stall_rate_floor)
    retry = torch.where(stalled, ct.retry + 1, torch.where(mig, 0, ct.retry))
    failed = stalled & (retry > cfg.max_retries)

    # done: release the source (the destination was reserved at the start)
    hosts = _free_resources(sim.hosts, ct.req, ct.host, done)
    # failed: release both the source and the reserved destination
    hosts = _free_resources(hosts, ct.req, ct.host, failed)
    hosts = _free_resources(hosts, ct.req, ct.mig_dst, failed)

    status = torch.where(done, STATUS_RUNNING, ct.status)
    status = torch.where(failed, STATUS_WAITING, status)
    conts = ct._replace(
        status=status,
        host=torch.where(done, ct.mig_dst, torch.where(failed, -1, ct.host)),
        mig_dst=torch.where(done | failed, -1, ct.mig_dst),
        mig_bytes_left=torch.where(done | failed, 0.0,
                                   torch.clamp(new_left, min=0.0)),
        n_migrations=torch.where(done, ct.n_migrations + 1, ct.n_migrations),
        retry=torch.where(failed, 0, retry),
    )
    return sim._replace(hosts=hosts, containers=conts)


def phase_execute(sim: SimState, cfg: SimConfig) -> SimState:
    """Paper ``run`` process: run_at += speed of the primary resource;
    crossing a communication trigger point pauses into COMMUNICATING."""
    ct = sim.containers
    H = sim.hosts.cap.shape[0]
    running = ct.status == STATUS_RUNNING
    hh = torch.clamp(ct.host, 0, H - 1).long()
    speed = sim.hosts.speed[hh, ct.ctype.long()]
    run_at = torch.where(running, ct.run_at + speed, ct.run_at)
    trigger = running & (ct.n_comms_left > 0) & (run_at >= ct.next_comm_at)
    peers = pick_comm_peers(ct)
    conts = ct._replace(
        run_at=run_at,
        status=torch.where(trigger, STATUS_COMMUNICATING, ct.status),
        comm_bytes_left=torch.where(trigger, ct.comm_bytes,
                                    ct.comm_bytes_left),
        comm_peer=torch.where(trigger, peers, ct.comm_peer),
        retry=torch.where(trigger, 0, ct.retry),
    )
    return sim._replace(containers=conts)


def phase_complete(sim: SimState) -> SimState:
    ct = sim.containers
    fin = ((ct.status == STATUS_RUNNING) & (ct.run_at >= ct.duration)
           & (ct.n_comms_left <= 0))
    hosts = _free_resources(sim.hosts, ct.req, ct.host, fin)
    conts = ct._replace(
        status=torch.where(fin, STATUS_COMPLETED, ct.status),
        finish_t=torch.where(fin, sim.t, ct.finish_t),
        host=torch.where(fin, -1, ct.host),
    )
    return sim._replace(hosts=hosts, containers=conts)


def phase_cost(sim: SimState) -> SimState:
    busy = (sim.hosts.n_containers > 0).to(F32)
    cost = (sim.hosts.price * busy).sum()
    hosts = sim.hosts._replace(busy_time=sim.hosts.busy_time + busy)
    return sim._replace(hosts=hosts, total_cost=sim.total_cost + cost)


# ---------------------------------------------------------------------------
# The tick and the driver
# ---------------------------------------------------------------------------
class TickInfo(NamedTuple):
    """Side outputs of one tick that the telescoping engine reads to judge
    quiescence: the flow allocation it used, the container fields
    ``phase_flows`` read (captured after the schedule, before the flows:
    when the tick's later phases leave them as they were, the next tick's
    rates are these) and whether the delay refresh fired."""
    comm_rates: torch.Tensor    # f32[C]
    mig_rates: torch.Tensor     # f32[C]
    flow_active: torch.Tensor   # bool[2C]
    all_rates: torch.Tensor     # f32[2C]
    mid_status: torch.Tensor    # i32[C]
    mid_host: torch.Tensor      # i32[C]
    mid_peer: torch.Tensor      # i32[C]
    mid_mig_dst: torch.Tensor   # i32[C]
    refreshed: bool


def make_refresh_fn(cfg: SimConfig, policy: PolicyParams, params: RunParams,
                    n_hosts: int, n_nodes: int):
    """The periodic delay-matrix rebuild as a ``net -> net`` function; its
    'fw' shortest paths are the route ``kernels.kernel_route`` gives
    ``cfg.delay_kernel`` on the policy's device."""
    apsp = (kernel_route(fw_minplus, cfg.delay_kernel,
                         policy.weights.device)
            if cfg.delay_mode == "fw" else network.floyd_warshall_ref)

    def refresh(net: NetState) -> NetState:
        return network.update_delay_matrix(
            net, n_hosts, n_nodes, mode=cfg.delay_mode,
            shortest_paths=apsp, q_coef=params.queue_coef,
            util_weight=policy.weights[W_UTIL],
            cross_leaf_ms=policy.weights[W_CROSS_LEAF])

    return refresh


def make_tick_ext(cfg: SimConfig, policy: PolicyParams, params: RunParams,
                  n_hosts: int, n_nodes: int):
    """Build the tick ``(sim, tt) -> (sim', metrics, TickInfo)``; ``tt`` is
    the tick index (a Python int, equal to ``sim.t``).  The sparse flow
    allocation is the route ``kernels.kernel_route`` gives
    ``cfg.waterfill_kernel`` on the policy's device."""
    allocate = (kernel_route(seg_waterfill, cfg.waterfill_kernel,
                             policy.weights.device)
                if cfg.sparse_flows else network.waterfill_sparse)
    refresh = make_refresh_fn(cfg, policy, params, n_hosts, n_nodes)

    def tick_ext(sim: SimState, tt: int):
        # each phase is a labelled range for torch.profiler
        # (repro_torch.launch.profile), inside the port's own ``tick``
        # span (core/trace.py); without a profiler they cost a few
        # microseconds a tick
        with trace.span("tick", tt):
            with record_function("phase_arrive"):
                sim, n_arrived = phase_arrive(sim)
            with record_function("phase_schedule"):
                sim, soft = phase_schedule_soft(sim, cfg, policy, params)
            # the state phase_flows reads; no later phase writes a tensor in
            # place, so these references keep its values
            mid = sim.containers
            with record_function("phase_flows"):
                sim, comm_rates, mig_rates, flow_active, all_rates = \
                    phase_flows(sim, cfg, allocate)
            with record_function("phase_progress"):
                sim = phase_communicate(sim, cfg, comm_rates)
                sim = phase_migrate(sim, cfg, mig_rates)
                sim = phase_execute(sim, cfg)
                sim = phase_complete(sim)
                sim = phase_cost(sim)
            # paper ``update_delay_matrix`` process: every
            # ``delay_update_interval`` ticks; 0 = once at t=0, then frozen
            if cfg.delay_update_interval == 0:
                every = tt == 0
            else:
                every = tt % cfg.delay_update_interval == 0
            if every:
                with record_function("delay_refresh"):
                    sim = sim._replace(net=refresh(sim.net))
            with record_function("stats_collect"):
                m = stats.collect(sim, n_arrived, sim.sched.decisions,
                                  sim.sched.migrations, params, flow_active,
                                  all_rates, soft=soft)
            sim = sim._replace(t=sim.t + 1.0)
            return sim, m, TickInfo(
                comm_rates=comm_rates, mig_rates=mig_rates,
                flow_active=flow_active, all_rates=all_rates,
                mid_status=mid.status, mid_host=mid.host,
                mid_peer=mid.comm_peer, mid_mig_dst=mid.mig_dst,
                refreshed=every)

    return tick_ext


def make_tick(cfg: SimConfig, policy: PolicyParams, params: RunParams,
              n_hosts: int, n_nodes: int):
    """The tick ``(sim, tt) -> (sim', metrics)``."""
    tick_ext = make_tick_ext(cfg, policy, params, n_hosts, n_nodes)

    def tick(sim: SimState, tt: int) -> Tuple[SimState, TickMetrics]:
        sim, m, _ = tick_ext(sim, tt)
        return sim, m

    return tick


def _start(sim: SimState, params: RunParams, t0: int) -> SimState:
    """The runtime link params applied when ``t0 == 0`` only:
    ``apply_link_params`` rebuilds ``comm_cost``, so applying them again
    at a later tick would wipe the refreshed delay matrix."""
    if t0 != 0:
        return sim
    return sim._replace(net=network.apply_link_params(
        sim.net, params.bw_mbps, params.loss))


def _tick_loop(sim: SimState, cfg: SimConfig, policy: PolicyParams,
               n_hosts: int, n_nodes: int, params: RunParams, t0: int,
               t1: int, fold, carry):
    """Ticks ``t0 .. t1 - 1`` from ``sim``, each tick's metrics folded into
    ``carry`` by ``fold(carry, tt, metrics)``; returns (state, carry).  The
    runtime link params are applied first when ``t0 == 0`` (:func:`_start`)."""
    sim = _start(sim, params, t0)
    tick = make_tick(cfg, policy, params, n_hosts, n_nodes)
    for tt in range(t0, t1):
        sim, m = tick(sim, tt)
        carry = fold(carry, tt, m)
    return sim, carry


def _append(ms: list, tt: int, m: TickMetrics) -> list:
    ms.append(m)
    return ms


def simulate(sim0: SimState, cfg: SimConfig, policy: PolicyParams,
             n_hosts: int, n_nodes: int, horizon: int,
             params: RunParams) -> Tuple[SimState, TickMetrics]:
    """Apply the runtime link params, then run ``horizon`` ticks; returns
    the final state and the per-tick metrics stacked along a trailing time
    axis."""
    if horizon < 1:
        raise ValueError("horizon must be >= 1")
    sim, ms = _tick_loop(sim0, cfg, policy, n_hosts, n_nodes, params, 0,
                         horizon, _append, [])
    return sim, TickMetrics(*(torch.stack(f) for f in zip(*ms)))


def use_deterministic(device: torch.device) -> None:
    """On a CUDA device, turn on ``torch.use_deterministic_algorithms`` for
    the process, so that no op of the tick takes an order that changes
    from run to run (every entry point that runs ticks calls this)."""
    if torch.device(device).type == "cuda":
        torch.use_deterministic_algorithms(True)


# ---------------------------------------------------------------------------
# Streaming (chunked) driver: O(state) memory at any horizon
# ---------------------------------------------------------------------------
def simulate_chunk(sim: SimState, acc: SummaryAcc, t0: int, cfg: SimConfig,
                   policy: PolicyParams, n_hosts: int, n_nodes: int,
                   chunk: int, params: RunParams
                   ) -> Tuple[SimState, SummaryAcc]:
    """One streamed chunk: ``chunk`` ticks from tick ``t0``, each tick's
    metrics folded into ``acc`` instead of stacked; the runtime link params
    are applied at ``t0 == 0`` only."""
    return _tick_loop(sim, cfg, policy, n_hosts, n_nodes, params, t0,
                      t0 + chunk, lambda a, tt, m: stats.acc_update(a, m),
                      acc)


# ---------------------------------------------------------------------------
# Telescoping (macro-tick) engine: quiescent intervals in cheap ticks
# ---------------------------------------------------------------------------
def _event_horizon(sim: SimState, info: TickInfo, t: int, t_end: int,
                   speed: torch.Tensor) -> torch.Tensor:
    """Closed-form event horizon after the full tick at ``t``: an f32 0-d
    tensor bounding the cheap-tick indices (cheap ticks run while
    ``t' < horizon``).  Exact parts: the segment end ``t_end`` (the next
    refresh tick or the chunk end) and the next arrival, ``ceil`` of the
    earliest pending ``submit_t`` after ``t`` (queried against ``t``, not
    ``t + 1``: a submit in ``(t, t + 1]`` arrives at the next tick).
    Estimated parts, ceil-divisions of the remaining work by the frozen
    rates and speeds: the earliest comm finish, migration finish, comm
    trigger and completion.  They only bound the loop: the exact one-step
    predicates are checked before every cheap tick (:func:`_cheap_ticks`),
    so equality with the per-tick path never rests on the divisions."""
    ct = sim.containers
    dev = ct.status.device
    t_f = torch.full((), t, dtype=F32, device=dev)

    def ceil_ticks(remaining, rate, mask):
        k = torch.ceil(remaining / torch.clamp(rate, min=1e-30))
        return torch.where(mask & (rate > 0), k, float("inf")).min()

    running = ct.status == STATUS_RUNNING
    horizon = torch.minimum(torch.full((), t_end, dtype=F32, device=dev),
                            torch.ceil(workload.next_arrival_after(ct, t_f)))
    for remaining, rate, mask in (
            (ct.comm_bytes_left, info.comm_rates,
             ct.status == STATUS_COMMUNICATING),
            (ct.mig_bytes_left, info.mig_rates,
             ct.status == STATUS_MIGRATING),
            (ct.next_comm_at - ct.run_at, speed,
             running & (ct.n_comms_left > 0)),
            (ct.duration - ct.run_at, speed,
             running & (ct.n_comms_left <= 0))):
        horizon = torch.minimum(horizon,
                                t_f + ceil_ticks(remaining, rate, mask))
    return horizon


def _cheap_ticks(sim: SimState, t: int, horizon: float, info: TickInfo,
                 speed: torch.Tensor) -> Tuple[SimState, int]:
    """Cheap ticks from tick ``t`` while ``t < horizon`` and no event falls
    on the tick: returns (state, the first tick not taken).  Before each
    tick the exact one-step predicates of the per-tick phases are checked
    on the live state (a comm or migration flow finishing, a comm trigger,
    a completion) and read back as one bool.  A cheap tick makes exactly
    the f32 updates a quiescent full tick makes, in the per-tick order:
    ``phase_communicate`` / ``phase_migrate`` progress clamped at 0 and
    the comm clock, ``phase_execute``'s speed, the retry counters reset
    for flows, ``phase_cost``'s busy clocks and cost, zero decisions and
    migrations, and the clock."""
    ct, hosts = sim.containers, sim.hosts
    dev = ct.status.device
    comm = ct.status == STATUS_COMMUNICATING
    mig = ct.status == STATUS_MIGRATING
    running = ct.status == STATUS_RUNNING
    comm_or_mig = comm | mig
    to_trigger = running & (ct.n_comms_left > 0)
    to_finish = running & (ct.n_comms_left <= 0)
    comm_f = comm.to(F32)
    busy_f = (hosts.n_containers > 0).to(F32)
    cost_q = (hosts.price * busy_f).sum()          # phase_cost's expression
    zero = torch.zeros((), dtype=I32, device=dev)
    while t < horizon:
        cc = sim.containers
        comm_left = cc.comm_bytes_left - info.comm_rates
        mig_left = cc.mig_bytes_left - info.mig_rates
        run_at = cc.run_at + speed
        event = ((comm & (comm_left <= 0.0)).any()
                 | (mig & (mig_left <= 0.0)).any()
                 | (to_trigger & (run_at >= cc.next_comm_at)).any()
                 | (to_finish & (run_at >= cc.duration)).any())
        with trace.host_sync("telescope_event"):
            stop = bool(event)
        if stop:
            break
        conts = cc._replace(
            comm_bytes_left=torch.clamp(
                torch.where(comm, comm_left, cc.comm_bytes_left), min=0.0),
            mig_bytes_left=torch.clamp(
                torch.where(mig, mig_left, cc.mig_bytes_left), min=0.0),
            comm_time=cc.comm_time + comm_f,
            run_at=torch.where(running, run_at, cc.run_at),
            retry=torch.where(comm_or_mig, 0, cc.retry),
        )
        sim = sim._replace(
            containers=conts,
            hosts=sim.hosts._replace(busy_time=sim.hosts.busy_time + busy_f),
            sched=sim.sched._replace(decisions=zero, migrations=zero),
            total_cost=sim.total_cost + cost_q,
            t=sim.t + 1.0)
        t += 1
    return sim, t


def _advance(sim: SimState, acc: SummaryAcc, t: int, info: TickInfo,
             seg_end: int, cfg: SimConfig, policy: PolicyParams,
             params: RunParams) -> Tuple[SimState, SummaryAcc, int]:
    """After the full tick at ``t``: when the state is quiescent, cheap
    ticks up to the event horizon (capped at ``seg_end``), their metrics
    folded at once; returns ``(state, acc, t2)``, ``t < t2 <= seg_end``.
    Quiescent: no delay refresh in the tick (a rebuilt fabric need not
    keep the rates), the fields ``phase_flows`` read unchanged since it
    ran (so the frozen rates are the next tick's), nothing waiting for
    the scheduler, no migration trigger armed and no active flow below
    ``stall_rate_floor`` (a stall counts a retry every tick).  The test
    and the horizon come to the host in one copy."""
    if info.refreshed:
        return sim, acc, t + 1
    ct = sim.containers
    st = ct.status
    H = sim.hosts.cap.shape[0]
    quiet = ((st == info.mid_status).all()
             & (ct.host == info.mid_host).all()
             & (ct.comm_peer == info.mid_peer).all()
             & (ct.mig_dst == info.mid_mig_dst).all())
    quiet &= ~((st == STATUS_INACTIVE) | (st == STATUS_WAITING)).any()
    util = sim.hosts.used / torch.clamp(sim.hosts.cap, min=1e-6)
    quiet &= ~((policy.weights[W_MIG_ENABLE] > 0)
               & (util.amax(dim=1) > params.overload_threshold).any())
    quiet &= ~(info.flow_active
               & (info.all_rates < cfg.stall_rate_floor)).any()
    speed = sim.hosts.speed[torch.clamp(ct.host, 0, H - 1).long(),
                            ct.ctype.long()]
    horizon = _event_horizon(sim, info, t, seg_end, speed)
    with trace.host_sync("telescope_horizon"):
        quiet, horizon = torch.stack([quiet.to(F32), horizon]).tolist()
    if not quiet:
        return sim, acc, t + 1
    sim, t2 = _cheap_ticks(sim, t + 1, horizon, info, speed)
    dt = t2 - (t + 1)
    if dt:
        # the skipped ticks' metrics, constant over the interval: no
        # arrivals, decisions or migrations, the frozen flows
        dev = st.device
        zero = torch.zeros((), dtype=I32, device=dev)
        m_q = stats.collect(sim, zero, zero, zero, params, info.flow_active,
                            info.all_rates)
        acc = stats.acc_update_weighted(
            acc, m_q, torch.full((), dt, dtype=I32, device=dev))
    return sim, acc, t2


def _telescope_loop(sim: SimState, cfg: SimConfig, policy: PolicyParams,
                    n_hosts: int, n_nodes: int, params: RunParams, t0: int,
                    t1: int, chunk: int, acc: SummaryAcc, on_chunk):
    """Ticks ``t0 .. t1 - 1`` telescoped, in chunks of ``chunk`` ticks from
    ``t0``: each chunk's accumulator (the first starting from ``acc``)
    goes to ``on_chunk`` at its end and is then reset.  Each macro step is
    one full tick (``make_tick_ext``, the per-tick path's phases), then
    :func:`_advance`.  The horizon is capped at the next refresh tick and
    the chunk end, so full ticks fall where the JAX package's do: at every
    chunk start and every refresh tick (with ``delay_update_interval``
    0, the refresh at tick 0 only), and after every event.  Returns
    (state, number of full ticks)."""
    if cfg.soft_placement:
        raise ValueError(
            "telescope + soft_placement is unsupported: the surrogate "
            "exists for the gradient, and a telescoped run skips the "
            "per-tick soft sums it differentiates; run grad work through "
            "the per-tick path (ExecPlan(chunk=...)) instead")
    sim = _start(sim, params, t0)
    tick_ext = make_tick_ext(cfg, policy, params, n_hosts, n_nodes)
    K = cfg.delay_update_interval
    device = sim.t.device
    t, n_full = t0, 0
    chunk_end = min(t0 + chunk, t1)
    while t < t1:
        sim, m, info = tick_ext(sim, t)
        acc = stats.acc_update(acc, m)
        n_full += 1
        seg_end = chunk_end if K == 0 else min((t // K + 1) * K, chunk_end)
        with trace.span("telescope_advance"):
            sim, acc, t = _advance(sim, acc, t, info, seg_end, cfg, policy,
                                   params)
        if t == chunk_end:
            on_chunk(acc)
            acc = stats.acc_init(device)
            chunk_end = min(t + chunk, t1)
    return sim, n_full


def simulate_telescoped(sim: SimState, acc: SummaryAcc, t0: int,
                        cfg: SimConfig, policy: PolicyParams, n_hosts: int,
                        n_nodes: int, chunk: int, params: RunParams,
                        with_stats: bool = False):
    """:func:`simulate_chunk` twin with event-horizon telescoping: the
    chunk's quiescent intervals advance in cheap ticks (the linear updates
    a quiescent full tick makes, the same f32 operations in the same
    order, so the final state is the per-tick run's bit for bit), their
    constant metrics folded at once (``stats.acc_update_weighted``:
    integer sums and peaks exact, float means to ~1 ulp).  Where the JAX
    engine hoists the delay refresh out of the tick for ``vmap``, the port
    runs one cell at a time and keeps the per-tick refresh, ending every
    cheap interval at the next refresh tick.  ``cfg.soft_placement``
    raises ``ValueError``.  ``with_stats`` also returns the number of
    full ticks (``chunk - n_full`` were telescoped)."""
    out = []
    sim, n_full = _telescope_loop(sim, cfg, policy, n_hosts, n_nodes, params,
                                  t0, t0 + chunk, chunk, acc, out.append)
    return (sim, out[0], n_full) if with_stats else (sim, out[0])


# ---------------------------------------------------------------------------
# Streamed runs: the per-tick and the telescoped loop
# ---------------------------------------------------------------------------
def stream_chunks(sim0: SimState, cfg: SimConfig, policy: PolicyParams,
                  n_hosts: int, n_nodes: int, horizon: int, chunk: int,
                  params: RunParams, on_chunk,
                  telescope: bool = False) -> SimState:
    """The horizon in chunks of ``chunk`` ticks (the last may be shorter):
    each tick folded into a ``SummaryAcc``, which goes to ``on_chunk`` at
    its chunk's end and is then reset.  Returns the final state, the
    stacked run's bit for bit.  The chunks are ``simulate_chunk``'s ticks
    (``telescope``: ``simulate_telescoped``'s) back to back in one loop,
    so no chunk's input state stays referenced while the next chunk
    runs."""
    stats.check_chunk(chunk, int(sim0.containers.status.shape[-1]))
    if horizon < 1:
        raise ValueError("horizon must be >= 1")
    device = sim0.t.device
    if telescope:
        return _telescope_loop(sim0, cfg, policy, n_hosts, n_nodes, params,
                               0, horizon, chunk, stats.acc_init(device),
                               on_chunk)[0]

    def fold(acc, tt, m):
        acc = stats.acc_update(acc, m)
        if (tt + 1) % chunk and tt + 1 < horizon:
            return acc
        on_chunk(acc)
        return stats.acc_init(device)

    sim, _ = _tick_loop(sim0, cfg, policy, n_hosts, n_nodes, params, 0,
                        horizon, fold, stats.acc_init(device))
    return sim


def run_sim_chunked(sim0: SimState, cfg: SimConfig, policy: PolicyParams,
                    n_hosts: int, n_nodes: int, horizon: int, chunk: int,
                    params: RunParams | None = None,
                    telescope: bool = False):
    """Streamed ``run_sim``: :func:`stream_chunks` (telescoped with
    ``telescope``), each chunk's accumulator folded into the host's
    f64/i64 totals with one device-to-host copy (``stats.online_fold``).
    Returns (final state, ``OnlineSummary``); the final state is the
    stacked run's bit for bit."""
    device = sim0.t.device
    use_deterministic(device)
    params = cfg.run_params(device) if params is None else params
    online = stats.online_init()

    def fold(acc):
        nonlocal online
        online = stats.online_fold(online, acc)

    sim = stream_chunks(sim0, cfg, policy, n_hosts, n_nodes, horizon, chunk,
                        params, fold, telescope=telescope)
    return sim, online


def run_sim(sim0: SimState, cfg: SimConfig, policy: PolicyParams,
            n_hosts: int, n_nodes: int, horizon: int,
            params: RunParams | None = None,
            plan: ExecPlan | None = None):
    """Run ``horizon`` ticks on the device ``sim0`` lives on.

    Without ``plan.chunk`` returns (final state, per-tick metrics stacked
    along a trailing time axis); with it the run streams through
    :func:`run_sim_chunked` and returns (final state, ``OnlineSummary``) —
    the same final state bit for bit; ``report.summarize`` takes either.
    ``plan.telescope`` streams the run through the telescoped engine
    (:func:`simulate_telescoped`; the whole horizon one chunk without
    ``plan.chunk``) and always returns an ``OnlineSummary``: skipped
    ticks have no rows to stack.  ``plan`` also carries the kernel
    selectors.  On a CUDA device this
    turns on ``torch.use_deterministic_algorithms`` for the process, so
    the final state is the same on every run.  ``sim0`` is never written
    to."""
    plan = ExecPlan() if plan is None else plan
    cfg = plan.apply_to_config(cfg)
    device = sim0.t.device
    params = cfg.run_params(device) if params is None else params
    chunk = plan.stream_chunk(horizon)
    if chunk is not None:
        return run_sim_chunked(sim0, cfg, policy, n_hosts, n_nodes, horizon,
                               chunk, params=params, telescope=plan.telescope)
    use_deterministic(device)
    return simulate(sim0, cfg, policy, n_hosts, n_nodes, horizon, params)
