"""The plain reference of the simulator: one tick after another in plain
PyTorch, no kernel, no streaming, no telescoping.

It is a frozen, trimmed copy of the port's per-tick path on its plain
versions (``repro_torch.core``: engine, scheduling, network, stats), kept
here so that a change to the port cannot move the yardstick.  It imports
nothing of the port and is built from the numpy inputs of
``dcbench.inputs`` alone: the fabric (its builder under
``reference/topologies/``, paths of any length), the policy weights and
every derived table are worked out again here.  Every float sum keeps
the port's order; the delay refresh's shortest paths relax one pivot at
a time (:func:`_apsp`).  On the CPU it is the port's CPU run bit for
bit.

The simulation is chaotic: an ulp of delay, which another association
of the shortest paths' sums moves, turns a tie between hosts and every
decision after it.  So :func:`run` can follow a program's delay
refreshes (``follow``): at each refresh it works its own matrix out,
takes its widest gap to the program's matrix of that refresh (over the
largest entry of its own), and goes on from the program's.

``lowp=True`` is the control: the network layer (the delay refresh's
all-pairs shortest paths and the flow allocation's rates) computed in
bfloat16, the precision below the configuration's float32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

F32, I32 = torch.float32, torch.int32
INF = 1e9
BIG = 1e18
INT_BIG = 2**31 - 1
MBPS_TO_KBPS = 125.0
LOCAL_RATE_KBPS = 4.0e6

UNBORN, INACTIVE, RUNNING, COMMUNICATING, MIGRATING, WAITING, COMPLETED = (
    -1, 0, 1, 2, 3, 4, 5)

# the policy weight layout: util, cross_leaf, sel_submit, sel_duration,
# 11 placement row weights, rr_track, mig_enable, 4 migration weights
WEIGHT_NAMES = (
    "util", "cross_leaf", "sel_submit", "sel_duration",
    "row_recency", "row_neg_speed", "row_worst_fit", "row_coloc",
    "row_comm", "row_fallback_worst", "row_host_util", "row_free_cpu",
    "row_free_mem", "row_uplink_util", "row_cross_leaf",
    "rr_track", "mig_enable", "mig_idx", "mig_path_util", "mig_cross_leaf",
    "mig_worst_fit")
W = {n: i for i, n in enumerate(WEIGHT_NAMES)}
ROW0, N_ROW, MIG0, N_MIG = 4, 11, 17, 4

POLICIES = {
    "firstfit": dict(row_recency=1.0),
    "round": dict(row_recency=1.0, rr_track=1.0),
    "performance_first": dict(row_neg_speed=1.0),
    "jobgroup": dict(row_coloc=1.0, row_fallback_worst=1.0),
    "netaware": dict(row_comm=1.0, row_fallback_worst=1.0, mig_enable=1.0,
                     mig_path_util=1.0),
    "overload_migrate": dict(row_recency=1.0, mig_enable=1.0, mig_idx=1.0),
}


def policy_weights(name: str) -> np.ndarray:
    w = np.zeros(len(WEIGHT_NAMES), np.float32)
    w[W["util"]], w[W["cross_leaf"]], w[W["sel_submit"]] = 1.0, 0.05, 1.0
    for k, v in POLICIES[name].items():
        w[W[k]] = v
    return w


class Sim(NamedTuple):
    t: torch.Tensor
    h: dict          # hosts: cap speed price used n leaf busy
    c: dict          # containers, the port's field names
    net: dict
    rr: torch.Tensor
    decisions: torch.Tensor
    migrations: torch.Tensor
    total_cost: torch.Tensor


# ---------------------------------------------------------------------------
# Network and state
# ---------------------------------------------------------------------------
def _sum_links(g):
    """A path's values added left to right over its trailing link axis:
    ((g0 + g1) + g2) + ..., the port's order at any path length."""
    total = g[..., 0]
    for i in range(1, g.shape[-1]):
        total = total + g[..., i]
    return total


def _padded(x):
    return torch.cat([x, x.new_zeros((1,))])


def network(fabric: dict, bw=None, loss=None) -> dict:
    """A run's network from a fabric's tables (a topology's
    ``build_net``): ``bw``/``loss`` applied as a run's overrides are,
    then the tables derived from them."""
    bw_t, lossv = fabric["link_bw"], fabric["link_loss"]
    if bw is not None:
        bw_t = torch.full_like(bw_t, bw)
    if loss is not None:
        lossv = torch.full_like(lossv, loss)
    pl_t = fabric["path_links"]
    net = dict(fabric, link_bw=bw_t, link_loss=lossv,
               link_bw_kbps=bw_t * MBPS_TO_KBPS,
               path_loss=_path_loss(lossv, pl_t),
               link_util=torch.zeros(bw_t.shape, dtype=F32,
                                     device=bw_t.device),
               delay_matrix=_sum_links(_padded(fabric["link_delay"])
                                       [pl_t.long()]))
    net["comm_cost"] = comm_cost(net)
    return net


def _path_loss(loss, pl):
    keep = _padded(torch.log1p(-torch.clamp(loss, 0.0, 0.99)))
    return 1.0 - torch.exp(_sum_links(keep[pl.long()]))


def comm_cost(net, util_weight=1.0, cross_leaf_ms=0.05):
    putil = _padded(net["link_util"])[net["path_links"].long()].amax(dim=-1)
    cross = (net["path_nlinks"] >= 4).to(F32)
    return net["delay_matrix"] + util_weight * putil + cross_leaf_ms * cross


def init_state(hosts: dict, cols: dict, net: dict, device) -> Sim:
    t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
    H = hosts["cap"].shape[0]
    C = cols["job"].shape[0]
    full = lambda v, dt: torch.full((C,), v, dtype=dt, device=device)
    c = dict(status=full(UNBORN, I32), run_at=full(0.0, F32),
             host=full(-1, I32), start_t=full(-1.0, F32),
             finish_t=full(-1.0, F32), comm_bytes_left=full(0.0, F32),
             comm_peer=full(-1, I32), comm_time=full(0.0, F32),
             retry=full(0, I32), mig_dst=full(-1, I32),
             mig_bytes_left=full(0.0, F32), n_migrations=full(0, I32))
    for k, v in cols.items():
        c[k] = t(v, I32 if np.asarray(v).dtype.kind == "i" else F32)
    h = dict(cap=t(hosts["cap"], F32), speed=t(hosts["speed"], F32),
             price=t(hosts["price"], F32), leaf=t(hosts["leaf"], I32),
             used=torch.zeros((H, 3), dtype=F32, device=device),
             n=torch.zeros((H,), dtype=I32, device=device),
             busy=torch.zeros((H,), dtype=F32, device=device))
    z = lambda dt, v=0: torch.full((), v, dtype=dt, device=device)
    return Sim(t=z(F32), h=h, c=c, net=net, rr=z(I32, -1),
               decisions=z(I32), migrations=z(I32), total_cost=z(F32))


# ---------------------------------------------------------------------------
# Sums in the port's order
# ---------------------------------------------------------------------------
def segment_sum(values, seg, n):
    """Each segment's rows added in ascending row order, from 0; ids >= n
    dropped."""
    keys, order = torch.sort(seg, stable=True)
    offsets = torch.searchsorted(keys, torch.arange(n + 1,
                                                    device=seg.device))
    width = int(np.prod(values.shape[1:], dtype=np.int64))
    out = torch.segment_reduce(values[order].reshape(-1, width), "sum",
                               offsets=offsets, axis=0, unsafe=True)
    return out.reshape((n,) + tuple(values.shape[1:]))


def take(x, i, dim=0):
    return x.index_select(dim, i.reshape(1).long()).squeeze(dim)


def _free(h, req, host_idx, mask):
    H = h["cap"].shape[0]
    m = mask & (host_idx >= 0)
    seg = torch.where(m, host_idx, H).long()
    dreq = segment_sum(req * m.to(F32)[:, None], seg, H)
    dcnt = torch.zeros((H + 1,), dtype=I32, device=req.device)
    dcnt.index_add_(0, seg, m.to(I32))
    return dict(h, used=h["used"] - dreq, n=h["n"] - dcnt[:H])


# ---------------------------------------------------------------------------
# Scheduling
# ---------------------------------------------------------------------------
def _feasible(cap, used, n, req, max_per_host):
    return ((used + req[None, :]) <= cap).all(dim=1) & (n < max_per_host)


def _deployed(c):
    st = c["status"]
    return (((st == RUNNING) | (st == COMMUNICATING) | (st == MIGRATING))
            & (c["host"] >= 0))


def _select_key(s: Sim, w):
    c = s.c
    pri = w[W["sel_submit"]] * c["submit_t"] + w[W["sel_duration"]] \
        * c["duration"]
    st = c["status"]
    mask = (c["submit_t"] <= s.t) & ((st == INACTIVE) | (st == WAITING))
    order = torch.argsort(pri, stable=True)
    rank = torch.argsort(order, stable=True).to(I32)
    return torch.where(mask, rank, INT_BIG)


def _same_job_counts(s: Sim, cand):
    H = s.h["cap"].shape[0]
    K = cand.shape[0]
    c = s.c
    jobs_k = c["job"][cand]
    eq = c["job"][:, None] == jobs_k[None, :]
    hit = eq.any(dim=1) & _deployed(c)
    k_first = torch.argmax(eq.to(torch.uint8), dim=1)
    hostc = torch.clamp(c["host"], 0, H - 1).long()
    seg = torch.where(hit, k_first * H + hostc, K * H)
    table = torch.zeros((K * H + 1,), dtype=F32, device=cand.device)
    table.index_add_(0, seg, hit.to(F32))
    kk = torch.argmax((jobs_k[None, :] == jobs_k[:, None]).to(torch.uint8),
                      dim=1)
    return table[:K * H].reshape(K, H)[kk]


def _row(s: Sim, w, rr, counts, leafpeers, k, cand, used):
    h, c = s.h, s.c
    H = h["cap"].shape[0]
    dev = used.device
    recency = torch.remainder(torch.arange(H, device=dev) - rr - 1,
                              H).to(F32)
    neg_speed = -take(h["speed"], take(c["ctype"], cand[k]), dim=1)
    free = (h["cap"] - used) / torch.clamp(h["cap"], min=1e-6)
    worst = -((free[:, 0] + free[:, 1]) + free[:, 2])
    cnt = counts[k]
    total = cnt.sum()
    has = total > 0
    coloc = torch.where(has, -cnt, 0.0)
    comm = torch.where(has, (cnt[:, None] * s.net["comm_cost"]).sum(0)
                       / torch.clamp(total, min=1.0), 0.0)
    fallback = torch.where(has, 0.0, worst)
    ratio = used / torch.clamp(h["cap"], min=1e-6)
    host_util = torch.maximum(torch.maximum(ratio[:, 0], ratio[:, 1]),
                              ratio[:, 2])
    uplink = s.net["link_util"][:H]
    cross = torch.where(has, (total - leafpeers[k])
                        / torch.clamp(total, min=1.0), 0.0)
    cols = (recency, neg_speed, worst, coloc, comm, fallback, host_util,
            free[:, 0], free[:, 1], uplink, cross)
    score = cols[0] * w[ROW0]
    for i in range(1, N_ROW):
        score = score + cols[i] * w[ROW0 + i]
    return score


def _place(s: Sim, sim: dict, w) -> Sim:
    """The conflict-resolved admit round: the K smallest selection keys
    admitted in order against the live host counters."""
    c, h = s.c, s.h
    C = c["status"].shape[0]
    H = h["cap"].shape[0]
    K = min(sim["placements_per_tick"], C)
    dev = s.t.device
    key = _select_key(s, w)
    distinct = torch.where(key < INT_BIG, key.long(),
                           C + torch.arange(C, device=dev))
    cand = torch.topk(distinct, K, largest=False, sorted=True).indices
    valid = key[cand] < INT_BIG
    req_k = c["req"][cand]
    counts = _same_job_counts(s, cand)
    leaf = h["leaf"].long()
    leafpeers = torch.zeros_like(counts).index_add_(1, leaf, counts)[:, leaf]
    rr = s.rr
    used, ncont = h["used"], h["n"]
    arange_h = torch.arange(H, device=dev)
    job = c["job"]
    chosen = [torch.full((), -1, dtype=torch.int64, device=dev)] * K
    for k in range(int(valid.sum())):
        feas = _feasible(h["cap"], used, ncont, req_k[k],
                         sim["max_containers_per_host"]) & valid[k]
        row = _row(s, w, rr, counts, leafpeers, k, cand, used)
        hk = torch.where(feas.any(),
                         torch.argmin(torch.where(feas, row, BIG)), -1)
        ok = hk >= 0
        hh = torch.clamp(hk, 0, H - 1)
        hot = (arange_h == hh) & ok
        used = torch.where(hot[:, None], used + req_k[k][None, :], used)
        ncont = torch.where(hot, ncont + 1, ncont)
        rr = torch.where(ok & (w[W["rr_track"]] > 0), hh.to(I32), rr)
        same = job[cand] == take(job, cand[k])
        counts = torch.where(hot[None, :] & same[:, None], counts + 1.0,
                             counts)
        on_leaf = (h["leaf"] == take(h["leaf"], hh)) & ok
        leafpeers = torch.where(on_leaf[None, :] & same[:, None],
                                leafpeers + 1.0, leafpeers)
        chosen[k] = hk
    chosen = torch.stack(chosen)
    ok = chosen >= 0
    hh = torch.clamp(chosen, 0, H - 1).to(I32)
    hit = ((cand[None, :] == torch.arange(C, device=dev)[:, None])
           & ok[None, :])
    sel, k_of = hit.any(dim=1), torch.argmax(hit.to(torch.uint8), dim=1)
    c = dict(c, status=torch.where(sel, RUNNING, c["status"]),
             host=torch.where(sel, hh[k_of], c["host"]),
             start_t=torch.where(sel & (c["start_t"] < 0), s.t,
                                 c["start_t"]),
             retry=torch.where(sel, 0, c["retry"]))
    return s._replace(c=c, h=dict(h, used=used, n=ncont), rr=rr,
                      decisions=s.decisions + ok.sum().to(I32))


def _first_true(key, mask):
    return torch.where(mask.any(), torch.argmin(torch.where(mask, key, BIG)),
                       -1)


def _migrate_step(s: Sim, sim: dict, rp: dict, w, used, ncont, status):
    h, c = s.h, s.c
    H = h["cap"].shape[0]
    C = status.shape[0]
    util = used / torch.clamp(h["cap"], min=1e-6)
    worst = util.amax(dim=1)
    src = _first_true(-worst, worst > rp["overload_threshold"])
    src_c = torch.clamp(src, 0, H - 1)
    bottleneck = torch.argmax(take(util, src_c))
    movable = (status == RUNNING) & (c["host"] == src_c)
    cont = _first_true(-take(c["req"], bottleneck, dim=1), movable)
    cont_c = torch.clamp(cont, 0, C - 1)
    feas = _feasible(h["cap"], used, ncont, take(c["req"], cont_c),
                     sim["max_containers_per_host"])
    idle = (util < rp["idle_threshold"]).all(dim=1)
    dst_mask = feas & idle & (torch.arange(H, device=util.device) != src_c)
    idx = torch.arange(H, dtype=F32, device=util.device)
    putil = _padded(s.net["link_util"])[
        take(s.net["path_links"], src_c).long()].amax(dim=-1)
    cross = (h["leaf"] != take(h["leaf"], src_c)).to(F32)
    free = (h["cap"] - used) / torch.clamp(h["cap"], min=1e-6)
    wf = -((free[:, 0] + free[:, 1]) + free[:, 2])
    feats = (idx, putil, cross, wf)
    score = feats[0] * w[MIG0]
    for i in range(1, N_MIG):
        score = score + feats[i] * w[MIG0 + i]
    dst = _first_true(score, dst_mask)
    ok = (src >= 0) & (cont >= 0) & (dst >= 0) & (w[W["mig_enable"]] > 0)
    return torch.where(ok, cont, -1), torch.where(ok, dst, -1)


def _migrate(s: Sim, sim: dict, rp: dict, w) -> Sim:
    c, h = s.c, s.h
    C = c["status"].shape[0]
    H = h["cap"].shape[0]
    used, ncont, status = h["used"], h["n"], c["status"]
    m1 = torch.full((), -1, dtype=torch.int64, device=status.device)
    n_steps = sim["migrations_per_tick"] if bool(w[W["mig_enable"]] > 0) \
        else 0
    cs, dsts = [m1] * sim["migrations_per_tick"], \
        [m1] * sim["migrations_per_tick"]
    for i in range(n_steps):
        # the port's migration step reads the live counters and status
        view = s._replace(h=dict(h, used=used, n=ncont),
                          c=dict(c, status=status))
        cc_, dst = _migrate_step(view, sim, rp, w, used, ncont, status)
        ok = (cc_ >= 0) & (dst >= 0)
        cc = torch.clamp(cc_, 0, C - 1)
        hh = torch.clamp(dst, 0, H - 1)
        hot_h = (torch.arange(H, device=hh.device) == hh) & ok
        used = torch.where(hot_h[:, None],
                           used + take(c["req"], cc)[None, :], used)
        ncont = torch.where(hot_h, ncont + 1, ncont)
        hot_c = (torch.arange(C, device=cc.device) == cc) & ok
        status = torch.where(hot_c, MIGRATING, status)
        cs[i] = torch.where(ok, cc, -1)
        dsts[i] = torch.where(ok, hh, -1)
        if not bool(ok):
            break
    cs = torch.stack(cs)
    dsts = torch.stack(dsts).to(I32)
    ok = cs >= 0
    hit = ((cs[None, :] == torch.arange(C, device=cs.device)[:, None])
           & ok[None, :])
    sel, m_of = hit.any(dim=1), torch.argmax(hit.to(torch.uint8), dim=1)
    c = dict(c, status=status,
             mig_dst=torch.where(sel, dsts[m_of], c["mig_dst"]),
             mig_bytes_left=torch.where(sel, sim["mig_kb_per_gb"]
                                        * c["req"][:, 1],
                                        c["mig_bytes_left"]),
             retry=torch.where(sel, 0, c["retry"]))
    return s._replace(c=c, h=dict(h, used=used, n=ncont),
                      migrations=s.migrations + ok.sum().to(I32))


# ---------------------------------------------------------------------------
# Network
# ---------------------------------------------------------------------------
def _waterfill(links, active, bw_kbps, tcp, n_rounds):
    F, P = links.shape
    E = bw_kbps.shape[0]
    valid = (links >= 0) & active[:, None]
    seg = torch.where(valid, links, E).reshape(-1).long()
    w_valid = valid.to(F32)

    def per_link(x):
        return segment_sum((x[:, None] * w_valid).reshape(-1), seg, E)

    def bound_of(unfrozen, cap_rem):
        cnt = per_link(unfrozen.to(F32))
        share = torch.where(cnt > 0, cap_rem / torch.clamp(cnt, min=1.0),
                            INF)
        padded = torch.cat([share, share.new_full((1,), INF)])
        return torch.where(valid, padded[seg.reshape(F, P)],
                           INF).amin(dim=1)

    alloc = torch.where(active, LOCAL_RATE_KBPS, 0.0)
    frozen = active & ~valid.any(dim=1)
    cap_rem = bw_kbps
    for _ in range(n_rounds):
        unfrozen = active & ~frozen
        bound = torch.where(unfrozen, bound_of(unfrozen, cap_rem), INF)
        m = bound.min()
        newly = unfrozen & (bound <= m * 1.000001 + 1e-6)
        alloc = torch.where(newly, torch.clamp(bound, max=LOCAL_RATE_KBPS),
                            alloc)
        used = per_link(torch.where(newly, alloc, 0.0))
        frozen = frozen | newly
        cap_rem = torch.clamp(cap_rem - used, min=0.0)
    leftover = active & ~frozen
    tail = torch.clamp(bound_of(leftover, cap_rem), max=LOCAL_RATE_KBPS)
    alloc = torch.where(leftover, tail, alloc)
    fair = torch.where(active, alloc, 0.0)
    rates = torch.minimum(fair, tcp) * active
    lvalid = links >= 0
    lseg = torch.where(lvalid, links, E).reshape(-1).long()
    load = segment_sum((rates[:, None] * lvalid.to(F32)).reshape(-1), lseg,
                       E)
    return rates, load


def _flows(s: Sim, sim: dict, lowp: bool):
    c, net = s.c, s.net
    C = c["status"].shape[0]
    peer = torch.clamp(c["comm_peer"], 0, C - 1).long()
    src = torch.cat([c["host"], c["host"]])
    dst = torch.cat([c["host"][peer], c["mig_dst"]])
    active = torch.cat([c["status"] == COMMUNICATING,
                        c["status"] == MIGRATING])
    src_c = torch.clamp(src, min=0).long()
    dst_c = torch.clamp(dst, min=0).long()
    bw = net["link_bw_kbps"]
    links = torch.where(active[:, None], net["path_links"][src_c, dst_c], -1)
    p = net["path_loss"][src_c, dst_c]
    rtt_s = torch.clamp(2.0 * net["delay_matrix"][src_c, dst_c],
                        min=1e-2) * 1e-3
    num = torch.tensor(1.22 * 1.46, dtype=F32, device=p.device)
    cap = torch.div(num, rtt_s * torch.sqrt(torch.clamp(p, min=1e-12)))
    tcp = torch.where(p > 1e-9, cap, INF)
    rates, load = _waterfill(links, active, bw, tcp, sim["waterfill_rounds"])
    if lowp:
        rates = rates.to(torch.bfloat16).to(F32)
    util = torch.where(bw > 0, load / torch.clamp(bw, min=1e-6), 0.0)
    s = s._replace(net=dict(net, link_util=torch.clamp(util, 0.0, 1.0)))
    return s, rates[:C], rates[C:], active, rates


def _apsp(A, lowp: bool):
    """All-pairs shortest paths, Floyd-Warshall one pivot at a time (in
    bfloat16 with ``lowp``)."""
    D = A.to(torch.bfloat16) if lowp else A
    for k in range(D.shape[0]):
        D = torch.minimum(D, D[:, k, None] + D[None, k, :])
    return D.to(F32)


def _refresh(s: Sim, sim: dict, rp: dict, w, lowp: bool,
             follow=None) -> tuple:
    """The refreshed state and, where ``follow`` is the program's matrix
    of this refresh, the widest gap of this one to it (the state goes on
    from ``follow``); else a gap of 0."""
    net = s.net
    H = s.h["cap"].shape[0]
    u = torch.clamp(net["link_util"], 0.0, 0.97)
    d_link = net["link_delay"] + torch.clamp(rp["queue_coef"] * u / (1.0 - u),
                                             max=20.0)
    if sim["delay_mode"] == "path":
        D = _sum_links(_padded(d_link)[net["path_links"].long()])
    else:
        n = H + int(s.net["n_switches"])
        a, b = net["link_u"].long(), net["link_v"].long()
        A = torch.full((n * n,), INF, dtype=F32, device=d_link.device)
        A = A.scatter_reduce(0, torch.cat([a * n + b, b * n + a]),
                             torch.cat([d_link, d_link]), reduce="amin",
                             include_self=True).reshape(n, n)
        D = _apsp(A.fill_diagonal_(0.0), lowp)[:H, :H].contiguous()
    gap = 0.0
    if follow is not None:
        theirs = follow.to(device=D.device, dtype=F32)
        if theirs.shape != D.shape:
            return s, float("inf"), D
        gap = float((theirs - D).abs().max() / D.abs().max().clamp(
            min=1e-30))
        D = theirs
    net = dict(net, delay_matrix=D)
    net["comm_cost"] = comm_cost(net, w[W["util"]], w[W["cross_leaf"]])
    return s._replace(net=net), gap, D


# ---------------------------------------------------------------------------
# Progress phases
# ---------------------------------------------------------------------------
def _communicate(s: Sim, sim: dict, rates) -> Sim:
    c = s.c
    comm = c["status"] == COMMUNICATING
    left = torch.where(comm, c["comm_bytes_left"] - rates,
                       c["comm_bytes_left"])
    done = comm & (left <= 0.0)
    stalled = comm & ~done & (rates < sim["stall_rate_floor"])
    retry = torch.where(stalled, c["retry"] + 1,
                        torch.where(comm, 0, c["retry"]))
    failed = stalled & (retry > sim["max_retries"])
    h = _free(s.h, c["req"], c["host"], failed)
    st = torch.where(done, RUNNING, c["status"])
    st = torch.where(failed, WAITING, st)
    c = dict(c, status=st,
             comm_bytes_left=torch.where(done | failed, 0.0,
                                         torch.clamp(left, min=0.0)),
             n_comms_left=torch.where(done, c["n_comms_left"] - 1,
                                      c["n_comms_left"]),
             next_comm_at=torch.where(done, c["next_comm_at"]
                                      + c["comm_work_gap"],
                                      c["next_comm_at"]),
             comm_peer=torch.where(done | failed, -1, c["comm_peer"]),
             comm_time=c["comm_time"] + comm.to(F32),
             retry=torch.where(failed, 0, retry),
             host=torch.where(failed, -1, c["host"]))
    return s._replace(h=h, c=c)


def _migrate_progress(s: Sim, sim: dict, rates) -> Sim:
    c = s.c
    mig = c["status"] == MIGRATING
    left = torch.where(mig, c["mig_bytes_left"] - rates,
                       c["mig_bytes_left"])
    done = mig & (left <= 0.0)
    stalled = mig & ~done & (rates < sim["stall_rate_floor"])
    retry = torch.where(stalled, c["retry"] + 1,
                        torch.where(mig, 0, c["retry"]))
    failed = stalled & (retry > sim["max_retries"])
    h = _free(s.h, c["req"], c["host"], done)
    h = _free(h, c["req"], c["host"], failed)
    h = _free(h, c["req"], c["mig_dst"], failed)
    st = torch.where(done, RUNNING, c["status"])
    st = torch.where(failed, WAITING, st)
    c = dict(c, status=st,
             host=torch.where(done, c["mig_dst"],
                              torch.where(failed, -1, c["host"])),
             mig_dst=torch.where(done | failed, -1, c["mig_dst"]),
             mig_bytes_left=torch.where(done | failed, 0.0,
                                        torch.clamp(left, min=0.0)),
             n_migrations=torch.where(done, c["n_migrations"] + 1,
                                      c["n_migrations"]),
             retry=torch.where(failed, 0, retry))
    return s._replace(h=h, c=c)


def _peers(c):
    C = c["status"].shape[0]
    idx = torch.arange(C, device=c["status"].device)
    member = _deployed(c) & (c["job"] >= 0)
    seg = torch.clamp(c["job"], 0, C - 1).long()

    def seg_min(key):
        return torch.full((C,), C, dtype=idx.dtype, device=idx.device) \
            .scatter_reduce(0, seg, key, reduce="amin", include_self=True)

    first = seg_min(torch.where(member, idx, C))[seg]
    is_first = member & (idx == first)
    second = seg_min(torch.where(member & ~is_first, idx, C))[seg]
    peer = torch.where(first == idx, second, first)
    has = (c["job"] >= 0) & (peer < C)
    return torch.where(has, peer, idx).to(I32)


def _execute(s: Sim) -> Sim:
    c = s.c
    H = s.h["cap"].shape[0]
    running = c["status"] == RUNNING
    hh = torch.clamp(c["host"], 0, H - 1).long()
    speed = s.h["speed"][hh, c["ctype"].long()]
    run_at = torch.where(running, c["run_at"] + speed, c["run_at"])
    trig = running & (c["n_comms_left"] > 0) & (run_at >= c["next_comm_at"])
    peers = _peers(c)
    c = dict(c, run_at=run_at,
             status=torch.where(trig, COMMUNICATING, c["status"]),
             comm_bytes_left=torch.where(trig, c["comm_bytes"],
                                         c["comm_bytes_left"]),
             comm_peer=torch.where(trig, peers, c["comm_peer"]),
             retry=torch.where(trig, 0, c["retry"]))
    return s._replace(c=c)


def _complete(s: Sim) -> Sim:
    c = s.c
    fin = ((c["status"] == RUNNING) & (c["run_at"] >= c["duration"])
           & (c["n_comms_left"] <= 0))
    h = _free(s.h, c["req"], c["host"], fin)
    c = dict(c, status=torch.where(fin, COMPLETED, c["status"]),
             finish_t=torch.where(fin, s.t, c["finish_t"]),
             host=torch.where(fin, -1, c["host"]))
    return s._replace(h=h, c=c)


def _cost(s: Sim) -> Sim:
    busy = (s.h["n"] > 0).to(F32)
    return s._replace(h=dict(s.h, busy=s.h["busy"] + busy),
                      total_cost=s.total_cost
                      + (s.h["price"] * busy).sum())


METRIC_NAMES = ("t", "n_overloaded", "n_inactive", "n_running",
                "n_deployed", "n_communicating", "n_waiting", "n_completed",
                "n_migrating", "new_arrivals", "decisions", "migrations",
                "util_variance", "mean_util", "active_flows",
                "mean_flow_rate")


def _collect(s: Sim, arrived, rp, active, rates) -> tuple:
    st = s.c["status"]
    util = s.h["used"] / torch.clamp(s.h["cap"], min=1e-6)
    worst = util.amax(dim=1)
    mean_util = ((util[:, 0] + util[:, 1]) + util[:, 2]) / 3.0
    n_flows = active.sum().to(I32)
    mean_rate = torch.where(n_flows > 0, (rates * active).sum()
                            / torch.clamp(n_flows, min=1).to(F32), 0.0)
    codes = torch.tensor([INACTIVE, RUNNING, COMMUNICATING, MIGRATING,
                          WAITING, COMPLETED], dtype=st.dtype,
                         device=st.device)
    n_in, n_run, n_comm, n_mig, n_wait, n_done = \
        (st[:, None] == codes[None, :]).sum(dim=0).to(I32).unbind()
    return (s.t, (worst > rp["overload_threshold"]).sum().to(I32),
            n_in + n_wait, n_run, n_run + n_comm + n_mig, n_comm, n_wait,
            n_done, n_mig, arrived.to(I32), s.decisions, s.migrations,
            torch.var(mean_util, correction=0), mean_util.mean(), n_flows,
            mean_rate)


class Delays:
    """A run's delay refreshes: the program's matrices it follows, in
    order (``follow``; None follows none), the widest gap of its own to
    them, and the matrices the run went on from (``used``)."""

    def __init__(self, follow=None):
        self.follow = None if follow is None else list(follow)
        self.used = []
        self.gap = 0.0

    def refresh(self, s: Sim, sim: dict, rp: dict, w, lowp: bool) -> Sim:
        theirs = None
        if self.follow is not None:
            i = len(self.used)
            if i < len(self.follow):
                theirs = self.follow[i]
            else:                    # a refresh the program did not make
                self.gap = float("inf")
        s, gap, D = _refresh(s, sim, rp, w, lowp, theirs)
        self.gap = max(self.gap, gap)
        self.used.append(D)
        return s

    def final_gap(self) -> float:
        """The widest gap, infinite where the program made another number
        of refreshes than the run."""
        if self.follow is not None and len(self.follow) != len(self.used):
            return float("inf")
        return self.gap


def tick(s: Sim, tt: int, sim: dict, rp: dict, w, lowp: bool = False,
         delays: Delays | None = None):
    c = s.c
    arriving = (c["status"] == UNBORN) & (c["submit_t"] <= s.t)
    s = s._replace(c=dict(c, status=torch.where(arriving, INACTIVE,
                                                c["status"])))
    zero = torch.zeros((), dtype=I32, device=s.t.device)
    s = s._replace(decisions=zero, migrations=zero)
    s = _place(s, sim, w)
    s = _migrate(s, sim, rp, w)
    s, comm_rates, mig_rates, active, rates = _flows(s, sim, lowp)
    s = _communicate(s, sim, comm_rates)
    s = _migrate_progress(s, sim, mig_rates)
    s = _execute(s)
    s = _complete(s)
    s = _cost(s)
    K = sim["delay_update_interval"]
    if (tt == 0) if K == 0 else (tt % K == 0):
        s = (delays or Delays()).refresh(s, sim, rp, w, lowp)
    m = _collect(s, arriving.sum(), rp, active, rates)
    return s._replace(t=s.t + 1.0), m


def run(hosts: dict, cols: dict, fabric: dict, sim: dict, policy: str,
        horizon: int, device, lowp: bool = False, scenario: dict | None = None,
        follow=None, record: list | None = None):
    """One whole run over ``fabric`` (a topology's ``build_net`` on
    ``device``): returns (final ``Sim``, per-tick metrics as a dict of
    host numpy series, the widest delay gap to ``follow``).
    ``scenario`` holds a run's overrides (bw, loss, queue_coef,
    overload_threshold, idle_threshold); ``follow`` the program's delay
    matrices of each refresh, to go on from (module docstring);
    ``record`` takes the matrices the run went on from."""
    sc = scenario or {}
    net = network(fabric, bw=sc.get("bw"), loss=sc.get("loss"))
    s = init_state(hosts, cols, net, device)
    rp = {k: torch.tensor(sc.get(k, sim[k]), dtype=F32, device=device)
          for k in ("queue_coef", "overload_threshold", "idle_threshold")}
    w = torch.tensor(policy_weights(policy), device=device)
    series, delays = [], Delays(follow)
    with torch.no_grad():
        for tt in range(horizon):
            s, m = tick(s, tt, sim, rp, w, lowp, delays)
            series.append(torch.stack([x.to(torch.float64) for x in m]))
        table = torch.stack(series).cpu().numpy()
    if record is not None:
        record.extend(delays.used)
    return (s, {n: table[:, i] for i, n in enumerate(METRIC_NAMES)},
            delays.final_gap())
