"""Network simulation module (paper §3.4), tensor-native, in PyTorch.

Counterpart of ``repro.core.network``.  Mininet's emulated fabric is an
analytic flow-level model:

* ``ping``-refreshed delay matrix -> the ECMP path sum, or min-plus
  Floyd-Warshall over the congestion-adjusted link graph
  (:func:`floyd_warshall_ref`);
* ``iperf`` transfers -> per-flow rate = min(max-min-fair share by
  progressive filling, Mathis TCP bound MSS / (RTT * sqrt(p)))
  (:func:`waterfill_sparse`).

This module launches no kernel and imports none: the engine hands
:func:`update_delay_matrix` and :func:`flow_rates` the callable to run in
place of each plain function, on a card the ``fw_minplus`` and
``seg_waterfill`` CUDA kernels (``kernels.kernel_route``).

Every per-link reduction is a :func:`segment_sum` onto E segments in
slot order (id E marks a pad slot, dropped), the order ``jax.ops.segment_sum``
adds in on the CPU, so the float sums agree with the JAX package, and the
card's with the CPU's.  Sums over a path's links (four on the spine-leaf
fabric, six on the fat tree) are written out left to right for the same
reason.

Two fabrics build the same :class:`NetState`: the paper's spine-leaf
(:class:`SpineLeafSpec`) and the k-ary fat tree of Al-Fares et al.
(:class:`FatTreeSpec`).  Host ``h``'s access link is link ``h`` in both,
and a path is padded with -1 to the fabric's longest (its width P).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.types import NetState, resolve_device, take

INF = 1e9
MBPS_TO_KBPS = 125.0  # 1 Mbps = 125 KB/s
LOCAL_RATE_KBPS = 4.0e6  # same-host "loopback" transfer rate
# comm-cost weights every policy's weight vector defaults to
# (scheduling.weight_vector); the engine re-weights at every refresh
DEFAULT_UTIL_WEIGHT = 1.0     # ms-equivalent at 100% path utilization
DEFAULT_CROSS_LEAF_MS = 0.05  # penalty for leaving the first-hop switch

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


@dataclasses.dataclass(frozen=True)
class FatTreeSpec:
    """The k-ary fat tree (Al-Fares, Loukissas and Vahdat, SIGCOMM 2008,
    §3): k pods of k/2 edge and k/2 aggregation switches, (k/2)^2 core
    switches, k^3/4 hosts, k/2 hosts an edge switch; every link at one
    bandwidth, delay and loss."""
    k: int = 4
    link_bw_mbps: float = 1000.0
    link_delay_ms: float = 0.05
    loss: float = 0.0

    def __post_init__(self):
        if self.k < 2 or self.k % 2:
            raise ValueError(f"a fat tree's k must be even and >= 2, "
                             f"got {self.k}")

    @property
    def n_hosts(self) -> int:
        return self.k ** 3 // 4

    @property
    def n_edge(self) -> int:
        """Edge switches (and as many aggregation switches): k^2/2."""
        return self.k * self.k // 2

    @property
    def n_nodes(self) -> int:
        return self.n_hosts + 2 * self.n_edge + (self.k // 2) ** 2

    @property
    def n_links(self) -> int:
        return 3 * self.n_hosts


def _spine_leaf_tables(spec: SpineLeafSpec) -> tuple:
    """Node numbering: hosts [0, H), leaves [H, H+L), spines [H+L, H+L+S).
    Link numbering: host-leaf links [0, H) (link i connects host i to its
    leaf ``i % L``), then leaf-spine links H + l * S + s.  Paths: two links
    within a leaf; across, deterministic ECMP hashes pair (i, j) onto spine
    (i + j) % S."""
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
    return link_u, link_v, link_bw, path_links, path_nlinks


def _fat_tree_tables(spec: FatTreeSpec) -> tuple:
    """With h = k/2: host d hangs off edge switch ``d % (k^2/2)``, at index
    ``j = d // (k^2/2)`` under it; edge switch e is in pod ``e // h`` at
    index ``s = e % h``; core switch ``c = a * h + m`` links to aggregation
    switch a of every pod.  Nodes: hosts, edges, aggregations (pod p's
    a-th at ``p * h + a``), cores.  Links: host d's is link d; edge (p, s)
    to aggregation (p, a) is ``H + p h^2 + s h + a``; aggregation (p, a)
    to core port m is ``H + k h^2 + p h^2 + a h + m``.  Routing by the
    paper's two-level suffix tables (§3.3): edge index s goes up to
    aggregation ``a = (j_dst + s) % h``, which goes up to core port
    ``m = (j_dst + a) % h``; the path comes down through the destination
    pod's aggregation a and its edge.  Paths of 2 links under one edge, 4
    within a pod, 6 across pods."""
    k, h = spec.k, spec.k // 2
    H, n_edge = spec.n_hosts, spec.n_edge
    d = np.arange(H)
    edge, below = d % n_edge, d // n_edge
    pod, idx = edge // h, edge % h
    # (p, x, y) in link order: edge (p, s = x) to aggregation (p, a = y),
    # then aggregation (p, a = x) to core port m = y
    p, x, y = (g.reshape(-1) for g in np.meshgrid(
        np.arange(k), np.arange(h), np.arange(h), indexing="ij"))
    link_u = np.concatenate([d, H + p * h + x, H + n_edge + p * h + x])
    link_v = np.concatenate([H + edge, H + n_edge + p * h + y,
                             H + 2 * n_edge + x * h + y])
    link_u, link_v = link_u.astype(np.int32), link_v.astype(np.int32)
    link_bw = np.full(spec.n_links, spec.link_bw_mbps, np.float32)

    I, J = np.meshgrid(d, d, indexing="ij")
    pi, pj, si, sj = pod[I], pod[J], idx[I], idx[J]
    up = (below[J] + si) % h                      # aggregation a
    core = (below[J] + up) % h                    # core port m
    same_edge = (edge[I] == edge[J]) & (I != J)
    same_pod = (pi == pj) & (edge[I] != edge[J])
    cross = pi != pj
    edge_up = H + pi * h * h + si * h + up
    edge_down = H + pj * h * h + sj * h + up
    pl = np.full((H, H, 6), -1, np.int32)
    pl[..., 0] = np.where(same_edge | same_pod | cross, I, -1)
    pl[same_edge, 1] = J[same_edge]
    pl[same_pod, 1] = edge_up[same_pod]
    pl[same_pod, 2] = edge_down[same_pod]
    pl[same_pod, 3] = J[same_pod]
    pl[cross, 1] = edge_up[cross]
    pl[cross, 2] = (H + k * h * h + pi * h * h + up * h + core)[cross]
    pl[cross, 3] = (H + k * h * h + pj * h * h + up * h + core)[cross]
    pl[cross, 4] = edge_down[cross]
    pl[cross, 5] = J[cross]
    nl = (2 * same_edge + 4 * same_pod + 6 * cross).astype(np.int32)
    return link_u, link_v, link_bw, pl, nl


def build_network(spec: SpineLeafSpec | FatTreeSpec, device=None) -> NetState:
    """Link tables + deterministic paths of the fabric ``spec`` describes:
    the spine-leaf (:func:`_spine_leaf_tables`) or the fat tree
    (:func:`_fat_tree_tables`); ``path_links`` [H, H, P] with -1 pads,
    ``path_nlinks`` [H, H] (0 from a host to itself)."""
    device = resolve_device(device)
    tables = (_fat_tree_tables if isinstance(spec, FatTreeSpec)
              else _spine_leaf_tables)
    link_u, link_v, link_bw, path_links, path_nlinks = tables(spec)
    H, E = spec.n_hosts, spec.n_links

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
def _sum(g: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing path axis of P links, added left to right:
    ((g0 + g1) + g2) + ...  At P = 4 these are the spine-leaf fabric's
    four-link sums, operation for operation."""
    total = g[..., 0] + g[..., 1]
    for i in range(2, g.shape[-1]):
        total = total + g[..., i]
    return total


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
    return _sum(_padded(link_delay)[path_links.long()])


def path_loss_matrix(link_loss: torch.Tensor,
                     path_links: torch.Tensor) -> torch.Tensor:
    """End-to-end loss 1 - prod(1 - loss_e) along each ECMP path."""
    keep = _padded(torch.log1p(-torch.clamp(link_loss, 0.0, 0.99)))
    return 1.0 - torch.exp(_sum(keep[path_links.long()]))


def path_util_matrix(net: NetState) -> torch.Tensor:
    """Max link utilization along the ECMP path between every host pair."""
    return _padded(net.link_util)[net.path_links.long()].amax(dim=-1)


def path_util_row(net: NetState, src: torch.Tensor) -> torch.Tensor:
    """One source row of :func:`path_util_matrix` — f32[H], O(H·P)."""
    return _padded(net.link_util)[take(net.path_links, src).long()] \
        .amax(dim=-1)


def pairwise_comm_cost(net: NetState, util_weight=DEFAULT_UTIL_WEIGHT,
                       cross_leaf_ms=DEFAULT_CROSS_LEAF_MS) -> torch.Tensor:
    """Expected cost [ms-equivalent] of communicating between host pairs:
    delay + ``util_weight`` * bottleneck path utilization + a
    ``cross_leaf_ms`` penalty for pairs whose path leaves the first-hop
    switch (four links or more: across the spine of a spine-leaf fabric;
    within a pod or across pods of a fat tree alike, which then differ by
    two links of delay and the path's bottleneck utilization)."""
    leaves_switch = (net.path_nlinks >= 4).to(F32)
    return (net.delay_matrix + util_weight * path_util_matrix(net)
            + cross_leaf_ms * leaves_switch)


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
                        mode: str = "path", shortest_paths=floyd_warshall_ref,
                        q_coef=0.5, util_weight=DEFAULT_UTIL_WEIGHT,
                        cross_leaf_ms=DEFAULT_CROSS_LEAF_MS) -> NetState:
    """Refresh the paper's delay_matrix (and comm_cost) from congestion.

    mode='path' — sum link delays along the fixed ECMP path (O(H^2)).
    mode='fw'   — full APSP over the node graph (the SDN-controller view)
                  by ``shortest_paths`` (A [n, n] -> D [n, n]): the plain
                  :func:`floyd_warshall_ref`, or the ``fw_minplus`` kernel
                  the engine routes here on a card.

    Under a profiler the shortest paths (the adjacency and the APSP, or
    the path sum) are the span ``apsp`` and the comm-cost rebuild the span
    ``comm_cost`` (``core/trace.py``).
    """
    d_link = congested_link_delay(net, q_coef=q_coef)
    with trace.span("apsp"):
        if mode == "path":
            D = path_delay_matrix(d_link, net.path_links)
        elif mode == "fw":
            A = adjacency_from_links(net, d_link, n_nodes)
            D = shortest_paths(A)[:n_hosts, :n_hosts].contiguous()
        else:
            raise ValueError(
                f"delay mode must be 'path' or 'fw', got {mode!r}")
    net = net._replace(delay_matrix=D)
    with trace.span("comm_cost"):
        cost = pairwise_comm_cost(net, util_weight=util_weight,
                                  cross_leaf_ms=cross_leaf_ms)
    return net._replace(comm_cost=cost)


# ---------------------------------------------------------------------------
# Flow-level rate allocation: sparse engine (default) and the dense [F, E]
# membership oracle (``sparse=False``).
# ---------------------------------------------------------------------------
def path_membership(path_links: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor, n_links: int) -> torch.Tensor:
    """[F, E] bool: does flow f traverse link e.  Same-host flows hit no
    link."""
    links = path_links[src.long(), dst.long()]                 # [F, P]
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


def segment_sum_count(values: torch.Tensor, seg: torch.Tensor,
                      n_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums, counts): the sums of the rows of ``values`` [N, ...] onto
    ``n_segments`` segments by the ids ``seg`` [N] (int64, >= 0; rows with
    an id >= n_segments, the pads, are dropped), each segment's rows added
    one after another in ascending row order, from 0, on every device; and
    the number of rows in each segment (int64), exact.  That order is the
    CPU's ``index_add_``'s and the JAX package's ``segment_sum``'s on the
    CPU, so the card's sums equal the CPU's bit for bit.  (On CUDA,
    deterministic ``index_add_`` adds a run of 32 or more equal 1-D ids
    lane-strided and then by a warp tree: another order.)

    A stable sort lists each segment's rows in row order, the pads last;
    ``searchsorted`` gives the segment offsets with no host sync
    (``bincount`` would read its maximum back), and their differences are
    the counts; ``segment_reduce`` sums each segment between its offsets.

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
    return (out.reshape((n_segments,) + tuple(values.shape[1:])),
            offsets.diff())


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """The sums of :func:`segment_sum_count`: each segment's rows in row
    order on every device, the pads (ids >= ``n_segments``) dropped."""
    return segment_sum_count(values, seg, n_segments)[0]


def max_min_fair_rates_sparse(flow_links: torch.Tensor, active: torch.Tensor,
                              link_bw_kbps: torch.Tensor,
                              n_rounds: int = 8) -> torch.Tensor:
    """Sparse progressive filling over the [F, P] per-flow link lists: the
    same rounds and freeze rule as :func:`max_min_fair_rates`, with every
    per-link reduction a segment sum over at most P link ids per flow."""
    F, P = flow_links.shape
    E = link_bw_kbps.shape[0]
    valid = (flow_links >= 0) & active[:, None]                  # [F, P]
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
        return torch.where(valid, padded[seg.reshape(F, P)], INF).amin(dim=1)

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


def waterfill_sparse(links: torch.Tensor, active: torch.Tensor,
                     link_bw_kbps: torch.Tensor, tcp_cap: torch.Tensor,
                     n_rounds: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rates [F], load [E]) from [F, P] link ids (-1 pad), any P: the
    sparse max-min-fair allocation (:func:`max_min_fair_rates_sparse`),
    its minimum with the Mathis ceiling ``tcp_cap`` [F], and each link's
    load, the rates summed in slot order (:func:`segment_sum`).  The plain
    version of the ``seg_waterfill`` kernel, which fuses the three."""
    E = link_bw_kbps.shape[0]
    active = active.to(torch.bool)
    fair = max_min_fair_rates_sparse(links, active, link_bw_kbps,
                                     n_rounds=n_rounds)
    rates = torch.minimum(fair, tcp_cap) * active
    valid = links >= 0
    seg = torch.where(valid, links, E).reshape(-1).long()
    w = (rates[:, None] * valid.to(F32)).reshape(-1)
    return rates, segment_sum(w, seg, E)


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


def _valid_slots(links: torch.Tensor) -> torch.Tensor:
    """int32 [P]: the flows with a link id at each path position, in two
    launches.  ``heaviside`` marks an id >= 0 with 1 in the ids' own dtype
    (its value at 0 a host scalar), so the sum casts nothing; a cast, or
    an explicit ``empty`` under deterministic algorithms, would launch
    more."""
    one = torch.ones((), dtype=links.dtype)
    return torch.heaviside(links, one).sum(0, dtype=links.dtype)


def flows_by_length(slots: list) -> dict:
    """Active flows by path length from the counts of their valid link
    slots by position (``slots[i]``: flows with more than i links; a
    path's pads trail it): ``{"flows_<L>link": n}`` for each length L
    that some flow had."""
    out = {}
    for i, n in enumerate(slots):
        n -= slots[i + 1] if i + 1 < len(slots) else 0
        if n:
            out[f"flows_{i + 1}link"] = n
    return out


def flow_rates(net: NetState, src: torch.Tensor, dst: torch.Tensor,
               active: torch.Tensor, n_rounds: int = 8, sparse: bool = True,
               allocate=waterfill_sparse
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allocate KB/s to each (src_host -> dst_host) flow; also link util.

    ``sparse`` selects the segment-based engine (default); ``sparse=False``
    runs the dense [F, E] membership oracle.  The sparse engine's
    allocation (all rounds + Mathis min + link load) is ``allocate``, with
    :func:`waterfill_sparse`'s arguments and results: that plain version,
    or the ``seg_waterfill`` kernel the engine routes here on a card.  Returns
    (rates [F], util [E]).  Under a profiler, on a fabric whose paths run
    past four links (the fat tree), the sparse engine counts the active
    flows by path length on the device (``flows_<L>link``, read back once,
    when the window's records are taken: :func:`flows_by_length`); a
    spine-leaf tick launches nothing more, traced or not.
    """
    E = net.link_bw.shape[0]
    src_c = torch.clamp(src, min=0).long()
    dst_c = torch.clamp(dst, min=0).long()
    bw_kbps = net.link_bw_kbps

    if sparse:
        links = torch.where(active[:, None], net.path_links[src_c, dst_c],
                            -1)
        if links.shape[1] > 4:      # paths through a fat tree's core
            trace.count_device("flow_links", lambda: _valid_slots(links),
                               flows_by_length)
        tcp = mathis_cap_sparse(net.delay_matrix, net.path_loss, src_c, dst_c)
        rates, load = allocate(links, active, bw_kbps, tcp, n_rounds=n_rounds)
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
