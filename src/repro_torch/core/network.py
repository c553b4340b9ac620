"""Network simulation module (paper §3.4), tensor-native, in PyTorch.

Counterpart of ``repro.core.network``.  Mininet's emulated fabric is an
analytic flow-level model:

* ``ping``-refreshed delay matrix -> the ECMP path sum, or min-plus
  Floyd-Warshall over the congestion-adjusted link graph (the
  ``fw_minplus`` CUDA kernel on a card, :func:`floyd_warshall_ref` here);
* ``iperf`` transfers -> per-flow rate = min(max-min-fair share by
  progressive filling, Mathis TCP bound MSS / (RTT * sqrt(p))); on a card
  the whole allocation is the ``seg_waterfill`` CUDA kernel.

Every per-link reduction is a :func:`segment_sum` onto E segments in
slot order (id E marks a pad slot, dropped), the order ``jax.ops.segment_sum``
adds in on the CPU, so the float sums agree with the JAX package, and the
card's with the CPU's.  Sums
over a path's four links are written out left to right for the same
reason.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.types import NetState, resolve_device, take

INF = 1e9
MBPS_TO_KBPS = 125.0  # 1 Mbps = 125 KB/s
LOCAL_RATE_KBPS = 4.0e6  # same-host "loopback" transfer rate
# comm-cost weights every policy's weight vector defaults to
# (scheduling.weight_vector); the engine re-weights at every refresh
DEFAULT_UTIL_WEIGHT = 1.0     # ms-equivalent at 100% path utilization
DEFAULT_CROSS_LEAF_MS = 0.05  # penalty for transiting the spine

F32 = torch.float32


# ---------------------------------------------------------------------------
# Topology construction (spine-leaf, paper Fig 3)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SpineLeafSpec:
    n_spine: int = 2
    n_leaf: int = 4
    n_hosts: int = 20
    host_leaf_bw: float = 1000.0   # Mbps
    leaf_spine_bw: float = 1000.0  # Mbps
    link_delay_ms: float = 0.05    # per-link base delay
    loss: float = 0.0              # per-link packet loss fraction

    @property
    def n_nodes(self) -> int:
        return self.n_hosts + self.n_leaf + self.n_spine

    @property
    def n_links(self) -> int:
        return self.n_hosts + self.n_leaf * self.n_spine


def build_network(spec: SpineLeafSpec, device=None) -> NetState:
    """Link tables + deterministic ECMP paths for a spine-leaf fabric.

    Node numbering: hosts [0, H), leaves [H, H+L), spines [H+L, H+L+S).
    Link numbering: host-leaf links [0, H) (link i connects host i to its
    leaf), then leaf-spine links H + l * S + s.
    """
    device = resolve_device(device)
    H, L, S = spec.n_hosts, spec.n_leaf, spec.n_spine
    E = spec.n_links

    host_leaf = np.arange(H) % L
    link_u = np.zeros(E, np.int32)
    link_v = np.zeros(E, np.int32)
    link_bw = np.zeros(E, np.float32)
    link_u[:H] = np.arange(H)
    link_v[:H] = H + host_leaf
    link_bw[:H] = spec.host_leaf_bw
    leaf, s = np.meshgrid(np.arange(L), np.arange(S), indexing="ij")
    link_u[H:] = (H + leaf).reshape(-1)
    link_v[H:] = (H + L + s).reshape(-1)
    link_bw[H:] = spec.leaf_spine_bw

    # Deterministic ECMP: pair (i, j) hashes onto spine (i + j) % S.
    I, J = np.meshgrid(np.arange(H), np.arange(H), indexing="ij")
    li, lj = host_leaf[I], host_leaf[J]
    same = (li == lj) & (I != J)
    cross = li != lj
    spine = (I + J) % S
    path_links = np.full((H, H, 4), -1, np.int32)
    path_links[same, 0] = I[same]
    path_links[same, 1] = J[same]
    path_links[cross, 0] = I[cross]
    path_links[cross, 1] = (H + li * S + spine)[cross]
    path_links[cross, 2] = (H + lj * S + spine)[cross]
    path_links[cross, 3] = J[cross]
    path_nlinks = np.where(same, 2, np.where(cross, 4, 0)).astype(np.int32)

    t = lambda x: torch.as_tensor(x, device=device)
    base_delay = t(np.full(E, spec.link_delay_ms, np.float32))
    loss = t(np.full(E, spec.loss, np.float32))
    pl = t(path_links)
    bw = t(link_bw)
    net = NetState(
        link_bw=bw,
        link_delay=base_delay,
        link_loss=loss,
        link_u=t(link_u),
        link_v=t(link_v),
        path_links=pl,
        path_nlinks=t(path_nlinks),
        link_bw_kbps=bw * MBPS_TO_KBPS,
        path_loss=path_loss_matrix(loss, pl),
        link_util=torch.zeros((E,), dtype=F32, device=device),
        delay_matrix=path_delay_matrix(base_delay, pl),
        comm_cost=torch.zeros((H, H), dtype=F32, device=device),
    )
    return net._replace(comm_cost=pairwise_comm_cost(net))


def apply_link_params(net: NetState, bw_mbps: torch.Tensor,
                      loss: torch.Tensor) -> NetState:
    """Uniform bandwidth/loss override (RunParams semantics): ``bw_mbps <=
    0`` / ``loss < 0`` keep the topology's per-link values.  The derived
    tables (``link_bw_kbps``, ``path_loss``, ``comm_cost``) are rebuilt."""
    new_bw = torch.where(bw_mbps > 0, bw_mbps, net.link_bw)
    new_loss = torch.where(loss >= 0, loss, net.link_loss)
    net = net._replace(
        link_bw=new_bw,
        link_bw_kbps=new_bw * MBPS_TO_KBPS,
        link_loss=new_loss,
        path_loss=path_loss_matrix(new_loss, net.path_links))
    return net._replace(comm_cost=pairwise_comm_cost(net))


def set_link_params(net: NetState, bw: float | None = None,
                    loss: float | None = None) -> NetState:
    """Override bandwidth / loss on every link (paper Fig 5/8 sweeps);
    values inside the keep-sentinel domain are rejected."""
    if bw is not None and bw <= 0:
        raise ValueError(f"bw override must be > 0 Mbps, got {bw}")
    if loss is not None and loss < 0:
        raise ValueError(f"loss override must be >= 0, got {loss}")
    dev = net.link_bw.device
    scalar = lambda v: torch.tensor(v, dtype=F32, device=dev)
    return apply_link_params(net, scalar(-1.0 if bw is None else bw),
                             scalar(-1.0 if loss is None else loss))


# ---------------------------------------------------------------------------
# Delay model
# ---------------------------------------------------------------------------
def _sum4(g: torch.Tensor) -> torch.Tensor:
    """Sum over a trailing axis of 4, added left to right."""
    return ((g[..., 0] + g[..., 1]) + g[..., 2]) + g[..., 3]


def _padded(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a trailing 0 that the -1 pad slots of a path index."""
    return torch.cat([x, x.new_zeros((1,))])


def congested_link_delay(net: NetState, q_coef=0.5,
                         max_q: float = 20.0) -> torch.Tensor:
    """Per-link delay = base + M/M/1-style queueing term from utilization."""
    u = torch.clamp(net.link_util, 0.0, 0.97)
    return net.link_delay + torch.clamp(q_coef * u / (1.0 - u), max=max_q)


def path_delay_matrix(link_delay: torch.Tensor,
                      path_links: torch.Tensor) -> torch.Tensor:
    """Host-to-host delay along the fixed ECMP path ('path' mode)."""
    return _sum4(_padded(link_delay)[path_links.long()])


def path_loss_matrix(link_loss: torch.Tensor,
                     path_links: torch.Tensor) -> torch.Tensor:
    """End-to-end loss 1 - prod(1 - loss_e) along each ECMP path."""
    keep = _padded(torch.log1p(-torch.clamp(link_loss, 0.0, 0.99)))
    return 1.0 - torch.exp(_sum4(keep[path_links.long()]))


def path_util_matrix(net: NetState) -> torch.Tensor:
    """Max link utilization along the ECMP path between every host pair."""
    return _padded(net.link_util)[net.path_links.long()].amax(dim=-1)


def path_util_row(net: NetState, src: torch.Tensor) -> torch.Tensor:
    """One source row of :func:`path_util_matrix` — f32[H], O(H·4)."""
    return _padded(net.link_util)[take(net.path_links, src).long()] \
        .amax(dim=-1)


def pairwise_comm_cost(net: NetState, util_weight=DEFAULT_UTIL_WEIGHT,
                       cross_leaf_ms=DEFAULT_CROSS_LEAF_MS) -> torch.Tensor:
    """Expected cost [ms-equivalent] of communicating between host pairs:
    delay + ``util_weight`` * bottleneck path utilization + a
    ``cross_leaf_ms`` penalty for pairs whose path transits the spine."""
    cross_spine = (net.path_nlinks >= 4).to(F32)
    return (net.delay_matrix + util_weight * path_util_matrix(net)
            + cross_leaf_ms * cross_spine)


def adjacency_from_links(net: NetState, link_delay: torch.Tensor,
                         n_nodes: int) -> torch.Tensor:
    """Symmetric node-graph adjacency with link delays; INF where no edge.

    The JAX package's ``segment_min`` over flattened (u, v) pair ids is a
    ``scatter_reduce('amin')`` onto an INF-filled table (min is
    order-free, so the result is the same)."""
    u = net.link_u.long()
    v = net.link_v.long()
    seg = torch.cat([u * n_nodes + v, v * n_nodes + u])
    vals = torch.cat([link_delay, link_delay])
    A = torch.full((n_nodes * n_nodes,), INF, dtype=F32,
                   device=link_delay.device)
    A = A.scatter_reduce(0, seg, vals, reduce="amin", include_self=True)
    A = A.reshape(n_nodes, n_nodes)
    return A.fill_diagonal_(0.0)


def floyd_warshall_ref(A: torch.Tensor) -> torch.Tensor:
    """Plain min-plus APSP, one pivot at a time (the fw_minplus kernel's
    plain version)."""
    D = A
    for k in range(A.shape[0]):
        D = torch.minimum(D, D[:, k, None] + D[None, k, :])
    return D


def update_delay_matrix(net: NetState, n_hosts: int, n_nodes: int,
                        mode: str = "path", use_kernel: bool = False,
                        q_coef=0.5, util_weight=DEFAULT_UTIL_WEIGHT,
                        cross_leaf_ms=DEFAULT_CROSS_LEAF_MS) -> NetState:
    """Refresh the paper's delay_matrix (and comm_cost) from congestion.

    mode='path' — sum link delays along the fixed ECMP path (O(H^2)).
    mode='fw'   — full APSP over the node graph (the SDN-controller view),
                  through the ``fw_minplus`` kernel when ``use_kernel``.
    """
    d_link = congested_link_delay(net, q_coef=q_coef)
    if mode == "path":
        D = path_delay_matrix(d_link, net.path_links)
    elif mode == "fw":
        A = adjacency_from_links(net, d_link, n_nodes)
        if use_kernel:
            from repro_torch.kernels.fw_minplus import floyd_warshall
            D_full = floyd_warshall(A)
        else:
            D_full = floyd_warshall_ref(A)
        D = D_full[:n_hosts, :n_hosts].contiguous()
    else:
        raise ValueError(f"delay mode must be 'path' or 'fw', got {mode!r}")
    net = net._replace(delay_matrix=D)
    return net._replace(comm_cost=pairwise_comm_cost(
        net, util_weight=util_weight, cross_leaf_ms=cross_leaf_ms))


# ---------------------------------------------------------------------------
# Flow-level rate allocation: sparse engine (default) and the dense [F, E]
# membership oracle (``sparse=False``).
# ---------------------------------------------------------------------------
def path_membership(path_links: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor, n_links: int) -> torch.Tensor:
    """[F, E] bool: does flow f traverse link e.  Same-host flows hit no
    link."""
    links = path_links[src.long(), dst.long()]                 # [F, 4]
    ids = torch.arange(n_links, device=links.device)
    return (links[:, :, None] == ids[None, None, :]).any(dim=1)


def _freeze_round(bound, unfrozen, alloc):
    """One progressive-filling freeze: flows within the freeze tolerance of
    the global minimum bound take it (capped at the loopback rate)."""
    m = bound.min()
    newly = unfrozen & (bound <= m * 1.000001 + 1e-6)
    new_alloc = torch.where(newly, torch.clamp(bound, max=LOCAL_RATE_KBPS),
                            alloc)
    return newly, new_alloc


def max_min_fair_rates(member: torch.Tensor, active: torch.Tensor,
                       link_bw_kbps: torch.Tensor,
                       n_rounds: int = 8) -> torch.Tensor:
    """Progressive-filling max-min fair allocation over the dense [F, E]
    membership (the oracle for the sparse engine)."""
    member_f = member.to(F32) * active[:, None]

    def fair_bound(unfrozen, cap_rem):
        cnt = (member_f * unfrozen[:, None].to(F32)).sum(0)         # [E]
        share = torch.where(cnt > 0, cap_rem / torch.clamp(cnt, min=1.0),
                            INF)
        return torch.where(member, share[None, :], INF).amin(dim=1)

    alloc = torch.where(active, LOCAL_RATE_KBPS, 0.0)
    frozen = active & ~member.any(dim=1)
    cap_rem = link_bw_kbps
    for _ in range(n_rounds):
        unfrozen = active & ~frozen
        bound = torch.where(unfrozen, fair_bound(unfrozen, cap_rem), INF)
        newly, alloc = _freeze_round(bound, unfrozen, alloc)
        used = (member_f * (newly * alloc)[:, None]).sum(0)
        frozen = frozen | newly
        cap_rem = torch.clamp(cap_rem - used, min=0.0)
    # flows still unfrozen after n_rounds get their current fair share
    leftover = active & ~frozen
    tail = torch.clamp(fair_bound(leftover, cap_rem), max=LOCAL_RATE_KBPS)
    alloc = torch.where(leftover, tail, alloc)
    return torch.where(active, alloc, 0.0)


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """Sums of the rows of ``values`` [N, ...] onto ``n_segments`` segments
    by the ids ``seg`` [N] (int64, >= 0; rows with an id >= n_segments,
    the pads, are dropped): each segment's rows added one after another in
    ascending row order, from 0, on every device.  That is the order of
    the CPU's ``index_add_`` and of the JAX package's ``segment_sum`` on
    the CPU, so the card's sums equal the CPU's bit for bit.  (On CUDA,
    deterministic ``index_add_`` adds a run of 32 or more equal 1-D ids
    lane-strided and then by a warp tree: another order.)

    A stable sort lists each segment's rows in row order, the pads last;
    ``searchsorted`` gives the segment offsets with no host sync
    (``bincount`` would read its maximum back); ``segment_reduce`` sums
    each segment between its offsets.

    The order on the card rests on behaviour that PyTorch does not
    document (``segment_reduce`` is a beta API), read on torch
    2.11.0+cu128: (1) its CUDA kernel walks each segment in row order, one
    thread a column, for data of two or more dimensions, while 1-D data
    goes to a tree reduction, so 1-D values go through as one column;
    (2) with ``unsafe=True`` it reads no row past the last offset, so the
    pads, sorted last, are never read.  After a torch upgrade, the
    ``cuda``-marked ``test_cuda_segment_sum_equals_cpu`` and
    ``test_cuda_free_resources_matches_cpu_at_real_size``
    (tests/test_torch_kernels.py) and ``chip_smoke.py`` phase 2 check both
    on the card."""
    keys, order = torch.sort(seg, stable=True)
    offsets = torch.searchsorted(
        keys, torch.arange(n_segments + 1, device=seg.device))
    width = int(np.prod(values.shape[1:], dtype=np.int64))
    out = torch.segment_reduce(values[order].reshape(-1, width), "sum",
                               offsets=offsets, axis=0, unsafe=True)
    return out.reshape((n_segments,) + tuple(values.shape[1:]))


def max_min_fair_rates_sparse(flow_links: torch.Tensor, active: torch.Tensor,
                              link_bw_kbps: torch.Tensor,
                              n_rounds: int = 8) -> torch.Tensor:
    """Sparse progressive filling over the [F, 4] per-flow link lists: the
    same rounds and freeze rule as :func:`max_min_fair_rates`, with every
    per-link reduction a segment sum over at most 4 link ids per flow."""
    F = flow_links.shape[0]
    E = link_bw_kbps.shape[0]
    valid = (flow_links >= 0) & active[:, None]                  # [F, 4]
    seg = torch.where(valid, flow_links, E).reshape(-1).long()
    w_valid = valid.to(F32)

    def per_link_sum(per_flow):                                   # [F]->[E]
        return segment_sum((per_flow[:, None] * w_valid).reshape(-1), seg,
                           E)

    def fair_bound(unfrozen, cap_rem):
        cnt = per_link_sum(unfrozen.to(F32))
        share = torch.where(cnt > 0, cap_rem / torch.clamp(cnt, min=1.0),
                            INF)
        padded = torch.cat([share, share.new_full((1,), INF)])
        return torch.where(valid, padded[seg.reshape(F, 4)], INF).amin(dim=1)

    alloc = torch.where(active, LOCAL_RATE_KBPS, 0.0)
    frozen = active & ~valid.any(dim=1)
    cap_rem = link_bw_kbps
    for _ in range(n_rounds):
        unfrozen = active & ~frozen
        bound = torch.where(unfrozen, fair_bound(unfrozen, cap_rem), INF)
        newly, alloc = _freeze_round(bound, unfrozen, alloc)
        used = per_link_sum(torch.where(newly, alloc, 0.0))
        frozen = frozen | newly
        cap_rem = torch.clamp(cap_rem - used, min=0.0)
    leftover = active & ~frozen
    tail = torch.clamp(fair_bound(leftover, cap_rem), max=LOCAL_RATE_KBPS)
    alloc = torch.where(leftover, tail, alloc)
    return torch.where(active, alloc, 0.0)


def mathis_cap(delay_matrix: torch.Tensor, link_loss: torch.Tensor,
               member: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               mss_kb: float = 1.46, c_mathis: float = 1.22) -> torch.Tensor:
    """TCP throughput ceiling under loss: C * MSS / (RTT * sqrt(p)) [KB/s]."""
    log_keep = torch.where(
        member, torch.log1p(-torch.clamp(link_loss, 0, 0.99))[None, :], 0.0)
    p = 1.0 - torch.exp(log_keep.sum(1))
    return _mathis_from_loss(delay_matrix, p, src, dst, mss_kb, c_mathis)


def mathis_cap_sparse(delay_matrix: torch.Tensor, path_loss: torch.Tensor,
                      src: torch.Tensor, dst: torch.Tensor,
                      mss_kb: float = 1.46,
                      c_mathis: float = 1.22) -> torch.Tensor:
    """Mathis bound from the precomputed [H, H] path-loss table."""
    return _mathis_from_loss(delay_matrix, path_loss[src.long(), dst.long()],
                             src, dst, mss_kb, c_mathis)


def _mathis_from_loss(delay_matrix, p, src, dst, mss_kb, c_mathis):
    rtt_ms = 2.0 * delay_matrix[src.long(), dst.long()]
    rtt_s = torch.clamp(rtt_ms, min=1e-2) * 1e-3
    # one rounding for the quotient, as in the JAX package: a Python
    # scalar over a tensor would go through reciprocal() and round twice
    num = torch.tensor(c_mathis * mss_kb, dtype=F32, device=p.device)
    cap = torch.div(num, rtt_s * torch.sqrt(torch.clamp(p, min=1e-12)))
    return torch.where(p > 1e-9, cap, INF)


def flow_rates(net: NetState, src: torch.Tensor, dst: torch.Tensor,
               active: torch.Tensor, n_rounds: int = 8, sparse: bool = True,
               use_kernel: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allocate KB/s to each (src_host -> dst_host) flow; also link util.

    ``sparse`` selects the segment-based engine (default); ``sparse=False``
    runs the dense [F, E] membership oracle.  ``use_kernel`` routes the
    sparse allocation through the ``seg_waterfill`` wrapper (all rounds +
    Mathis min + link load; on a CUDA tensor, the CUDA kernel).  Returns
    (rates [F], util [E]).
    """
    E = net.link_bw.shape[0]
    src_c = torch.clamp(src, min=0).long()
    dst_c = torch.clamp(dst, min=0).long()
    bw_kbps = net.link_bw_kbps

    if sparse:
        links = torch.where(active[:, None], net.path_links[src_c, dst_c],
                            -1)
        tcp = mathis_cap_sparse(net.delay_matrix, net.path_loss, src_c, dst_c)
        if use_kernel:
            from repro_torch.kernels.seg_waterfill import seg_waterfill
            rates, load = seg_waterfill(links, active, bw_kbps, tcp,
                                        n_rounds=n_rounds)
        else:
            from repro_torch.kernels.seg_waterfill import seg_waterfill_ref
            rates, load = seg_waterfill_ref(links, active, bw_kbps, tcp,
                                            n_rounds=n_rounds)
    else:
        member = path_membership(net.path_links, src_c, dst_c, E)
        member = member & active[:, None]
        fair = max_min_fair_rates(member, active, bw_kbps, n_rounds)
        tcp = mathis_cap(net.delay_matrix, net.link_loss, member, src_c,
                         dst_c)
        rates = torch.minimum(fair, tcp) * active
        load = (member.to(F32) * rates[:, None]).sum(0)
    util = torch.where(bw_kbps > 0,
                       load / torch.clamp(bw_kbps, min=1e-6), 0.0)
    return rates, torch.clamp(util, 0.0, 1.0)
