"""The k-ary fat tree (Al-Fares, Loukissas and Vahdat, SIGCOMM 2008, §3)
as the port builds it (``core.network.FatTreeSpec``).

A configuration whose ``fleet`` names ``"topology": "fat_tree"`` gets
this file, and the plain reference's twin of the same fabric at
``dcbench/reference/topologies/fat_tree.py``.  The fleet's keys: ``k``,
``hosts`` (k^3/4, checked), ``link_bw_mbps``, ``link_delay_ms``,
``link_loss``.  Host ``d`` hangs off edge switch ``d % (k^2/2)``; a path
is two links under one edge switch, four within a pod, six across pods;
the fabric has 5k^2/4 switches and 3k^3/4 links.
"""
from __future__ import annotations

import numpy as np

from dcbench import harness, program


def _k(fleet: dict) -> int:
    k = int(fleet["k"])
    if k < 2 or k % 2 or fleet["hosts"] != k ** 3 // 4:
        raise harness.RunError(
            f"a fat tree of k = {k} has {k ** 3 // 4} hosts (k even, >= 2);"
            f" the fleet gives {fleet['hosts']}")
    return k


def host_switch(fleet: dict) -> np.ndarray:
    """Each host's first-hop switch (the host tables' ``leaf``): its edge
    switch."""
    k = _k(fleet)
    return (np.arange(fleet["hosts"]) % (k * k // 2)).astype(np.int32)


def build(fleet: dict, device) -> tuple:
    """(the port's ``NetState`` on ``device``, n_hosts, n_nodes)."""
    k = _k(fleet)
    net_mod = program.port().network
    if not hasattr(net_mod, "FatTreeSpec"):
        raise harness.RunError(
            "the port has no fat-tree fabric (core.network.FatTreeSpec)")
    spec = net_mod.FatTreeSpec(k=k, link_bw_mbps=fleet["link_bw_mbps"],
                               link_delay_ms=fleet["link_delay_ms"],
                               loss=fleet["link_loss"])
    return (net_mod.build_network(spec, device=device), spec.n_hosts,
            spec.n_nodes)


def kernel_shapes(fleet: dict, sim: dict) -> dict:
    """The shapes a tick calls the simulator's kernels at: ``fw_minplus``
    over the fabric's k^3/4 + 5k^2/4 nodes (in ``'fw'`` delay mode) and
    ``seg_waterfill`` over F = 2C flows (a comm flow and a migration flow
    a container), E = 3k^3/4 links and paths of 6 link ids."""
    k = _k(fleet)
    H = k ** 3 // 4
    return {"fw_n": H + 5 * k * k // 4 if sim["delay_mode"] == "fw"
            else None,
            "waterfill_F": 2 * sim["n_containers"],
            "waterfill_E": 3 * H,
            "waterfill_hops": 6}
