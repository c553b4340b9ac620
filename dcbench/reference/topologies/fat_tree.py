"""The k-ary fat tree of the plain reference (Al-Fares, Loukissas and
Vahdat, SIGCOMM 2008, §3), worked out again from k: link tables and the
paths of the paper's two-level routing tables.

Imports nothing of the port and nothing of the benchmark.  The tables
are derived here another way than the port derives them: each link is
listed switch by switch, and a path is first the sequence of nodes the
routing tables send a packet through, then the link between each two
nodes of it, looked up in a node-by-node table of the links.

With h = k/2: host d hangs off edge switch ``d % (k^2/2)`` at index
``j = d // (k^2/2)`` under it; edge switch e is in pod ``e // h``; core
switch ``a * h + m`` is port m of aggregation index a in every pod.
Nodes are numbered hosts, edges, aggregations, cores.  Routing: the
edge switch at index s sends a packet for host index j up to
aggregation ``(j + s) % h``, which sends it up to core port
``(j + a) % h``; down from there the path is fixed.
"""
from __future__ import annotations

import numpy as np
import torch


def _links(k: int) -> tuple:
    """(link_u, link_v) in link order: the hosts' links, then each pod's
    edge-aggregation links (edge by edge), then its aggregation-core
    links (aggregation by aggregation)."""
    h = k // 2
    H, n_edge = k ** 3 // 4, k * k // 2
    edge_node = lambda p, s: H + p * h + s
    agg_node = lambda p, a: H + n_edge + p * h + a
    core_node = lambda a, m: H + 2 * n_edge + a * h + m
    u = [d for d in range(H)]
    v = [edge_node(*divmod(d % n_edge, h)) for d in range(H)]
    for p in range(k):
        for s in range(h):
            for a in range(h):
                u.append(edge_node(p, s))
                v.append(agg_node(p, a))
    for p in range(k):
        for a in range(h):
            for m in range(h):
                u.append(agg_node(p, a))
                v.append(core_node(a, m))
    return np.asarray(u, np.int64), np.asarray(v, np.int64)


def _node_paths(k: int) -> np.ndarray:
    """[H, H, 7] the nodes a packet from host i to host j passes, -1
    after its last: i, edge, (aggregation, (core, aggregation,)) edge,
    j; a host to itself passes none."""
    h = k // 2
    H, n_edge = k ** 3 // 4, k * k // 2
    src = np.arange(H)[:, None].repeat(H, 1)
    dst = np.arange(H)[None, :].repeat(H, 0)
    e_src, e_dst = src % n_edge, dst % n_edge
    pod_src, pod_dst = e_src // h, e_dst // h
    s_src, j_dst = e_src % h, dst // n_edge
    a = (j_dst + s_src) % h
    m = (j_dst + a) % h
    nodes = np.full((H, H, 7), -1, np.int64)
    up_edge, down_edge = H + e_src, H + e_dst
    up_agg = H + n_edge + pod_src * h + a
    down_agg = H + n_edge + pod_dst * h + a
    core = H + 2 * n_edge + a * h + m
    kind = np.where(src == dst, 0, np.where(
        e_src == e_dst, 1, np.where(pod_src == pod_dst, 2, 3)))
    rows = {1: (src, up_edge, dst),
            2: (src, up_edge, up_agg, down_edge, dst),
            3: (src, up_edge, up_agg, core, down_agg, down_edge, dst)}
    for kd, seq in rows.items():
        sel = kind == kd
        for pos, node in enumerate(seq):
            nodes[sel, pos] = node[sel]
    return nodes


def build_net(topo: dict, device) -> dict:
    """The fabric of ``topo`` (``k``, ``hosts`` = k^3/4, link bandwidth,
    loss and delay): link tables, [H, H, 6] link ids padded with -1, the
    path lengths and the switch count 5k^2/4."""
    k = int(topo["k"])
    if k < 2 or k % 2 or topo["hosts"] != k ** 3 // 4:
        raise ValueError(f"a fat tree of k = {k} has {k ** 3 // 4} hosts "
                         f"(k even, >= 2); the fleet gives {topo['hosts']}")
    H = k ** 3 // 4
    n_nodes = H + 5 * k * k // 4
    link_u, link_v = _links(k)
    E = link_u.shape[0]
    link_of = np.full((n_nodes, n_nodes), -1, np.int64)
    link_of[link_u, link_v] = np.arange(E)
    link_of[link_v, link_u] = np.arange(E)
    nodes = _node_paths(k)
    hop = (nodes[..., :-1] >= 0) & (nodes[..., 1:] >= 0)
    pl = np.where(hop, link_of[np.maximum(nodes[..., :-1], 0),
                               np.maximum(nodes[..., 1:], 0)], -1)
    nl = hop.sum(-1)
    t = lambda x: torch.as_tensor(x, device=device)
    return dict(link_bw=t(np.full(E, topo["link_bw_mbps"], np.float32)),
                link_delay=t(np.full(E, topo["link_delay_ms"], np.float32)),
                link_loss=t(np.full(E, topo["link_loss"], np.float32)),
                link_u=t(link_u.astype(np.int32)),
                link_v=t(link_v.astype(np.int32)),
                path_links=t(pl.astype(np.int32)),
                path_nlinks=t(nl.astype(np.int32)),
                n_switches=5 * k * k // 4)
