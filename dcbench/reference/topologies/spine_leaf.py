"""The spine-leaf fabric of the plain reference, worked out again from the
fleet's sizes: link tables and deterministic ECMP paths.

Imports nothing of the port and nothing of the benchmark.  The reference
(``dcbench/reference/sim.py``) applies a run's overrides and derives the
path tables' sums from what :func:`build_net` returns.
"""
from __future__ import annotations

import numpy as np
import torch


def build_net(topo: dict, device) -> dict:
    """The fabric of ``topo`` (hosts, leaves, spines, link bandwidth,
    loss and delay): link tables, paths over spine (i + j) % S for pair
    (i, j), [H, H, 4] link ids padded with -1, and the switch count."""
    H, L, S = topo["hosts"], topo["leaves"], topo["spines"]
    E = H + L * S
    host_leaf = np.arange(H) % L
    link_u = np.zeros(E, np.int32)
    link_v = np.zeros(E, np.int32)
    link_bw = np.zeros(E, np.float32)
    link_u[:H], link_v[:H] = np.arange(H), H + host_leaf
    link_bw[:H] = topo["link_bw_mbps"]
    lf, s = np.meshgrid(np.arange(L), np.arange(S), indexing="ij")
    link_u[H:], link_v[H:] = (H + lf).reshape(-1), (H + L + s).reshape(-1)
    link_bw[H:] = topo["link_bw_mbps"]
    I, J = np.meshgrid(np.arange(H), np.arange(H), indexing="ij")
    li, lj = host_leaf[I], host_leaf[J]
    same, cross = (li == lj) & (I != J), li != lj
    spine = (I + J) % S
    pl = np.full((H, H, 4), -1, np.int32)
    pl[same, 0], pl[same, 1] = I[same], J[same]
    pl[cross, 0] = I[cross]
    pl[cross, 1] = (H + li * S + spine)[cross]
    pl[cross, 2] = (H + lj * S + spine)[cross]
    pl[cross, 3] = J[cross]
    nl = np.where(same, 2, np.where(cross, 4, 0)).astype(np.int32)
    t = lambda x: torch.as_tensor(x, device=device)
    return dict(link_bw=t(link_bw),
                link_delay=t(np.full(E, topo["link_delay_ms"], np.float32)),
                link_loss=t(np.full(E, topo["link_loss"], np.float32)),
                link_u=t(link_u), link_v=t(link_v), path_links=t(pl),
                path_nlinks=t(nl), n_switches=L + S)
