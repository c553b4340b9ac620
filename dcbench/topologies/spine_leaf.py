"""The spine-leaf fabric (the paper's Fig 3) as the port builds it.

A configuration's ``fleet`` names its fabric (``topology``, this one
where it names none); the harness finds this file by that name, and the
plain reference's builder of the same fabric at
``dcbench/reference/topologies/spine_leaf.py``.  The fleet's keys:
``hosts``, ``leaves``, ``spines``, ``link_bw_mbps``, ``link_delay_ms``,
``link_loss``.  Host ``h`` hangs off leaf ``h % leaves``; a path is two
links within a leaf, four across the spines.
"""
from __future__ import annotations

import numpy as np

from dcbench import program


def host_switch(fleet: dict) -> np.ndarray:
    """Each host's first-hop switch (the host tables' ``leaf``)."""
    return (np.arange(fleet["hosts"]) % fleet["leaves"]).astype(np.int32)


def build(fleet: dict, device) -> tuple:
    """(the port's ``NetState`` on ``device``, n_hosts, n_nodes)."""
    net_mod = program.port().network
    spec = net_mod.SpineLeafSpec(
        n_spine=fleet["spines"], n_leaf=fleet["leaves"],
        n_hosts=fleet["hosts"], host_leaf_bw=fleet["link_bw_mbps"],
        leaf_spine_bw=fleet["link_bw_mbps"],
        link_delay_ms=fleet["link_delay_ms"], loss=fleet["link_loss"])
    return (net_mod.build_network(spec, device=device), spec.n_hosts,
            spec.n_nodes)


def kernel_shapes(fleet: dict, sim: dict) -> dict:
    """The shapes a tick calls the simulator's kernels at: ``fw_minplus``
    over the fabric's n nodes (in ``'fw'`` delay mode) and
    ``seg_waterfill`` over F = 2C flows (a comm flow and a migration flow
    a container), E links and paths of ``waterfill_hops`` link ids."""
    n_nodes = fleet["hosts"] + fleet["leaves"] + fleet["spines"]
    return {"fw_n": n_nodes if sim["delay_mode"] == "fw" else None,
            "waterfill_F": 2 * sim["n_containers"],
            "waterfill_E": fleet["hosts"] + fleet["leaves"] * fleet["spines"],
            "waterfill_hops": 4}
