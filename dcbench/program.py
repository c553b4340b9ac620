"""The system under test, built from the benchmark's numpy inputs.

The port (``repro_torch``, under ``src/`` of the checkout) is imported
here and nowhere else in the harness: the drivers reach it through
:func:`port`.  It is handed the host tables and the container columns of
``dcbench.inputs`` through its own constructors, and builds its network
(through the cell's topology, ``dcbench/topologies/``), its policy and
its run parameters itself.
"""
from __future__ import annotations

import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
_PORT = None


def port() -> SimpleNamespace:
    """The port's modules the drivers use, imported once."""
    global _PORT
    if _PORT is None:
        src = str(ROOT / "src")
        if src not in sys.path:
            sys.path.insert(0, src)
        names = ("core.types", "core.datacenter", "core.network",
                 "core.engine", "core.stats", "core.scheduling",
                 "core.scenario", "launch.sweep", "kernels")
        mods = {n.split(".")[-1]: importlib.import_module("repro_torch." + n)
                for n in names}
        _PORT = SimpleNamespace(**mods)
    return _PORT


def sim_config(sim: dict):
    """The port's ``SimConfig`` from a cell's merged ``sim`` settings;
    ranges become tuples."""
    p = port()
    return p.datacenter.SimConfig(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in sim.items()})


def initial_state(hosts: dict, cols: dict, net, device):
    """The port's initial ``SimState`` on ``device`` over ``net``, a
    fabric a topology built (one fabric may serve many states)."""
    p = port()
    h = p.types.make_hosts(hosts["cap"], hosts["speed"], hosts["price"],
                           hosts["leaf"], device=device)
    ct = p.types.empty_containers(cols["job"].shape[0], device=device)
    ct = ct._replace(**{k: torch.as_tensor(np.asarray(v), device=device)
                        for k, v in cols.items()})
    return p.engine.init_sim(h, ct, net)


def state_to_host(sim) -> dict:
    """The compared leaves of a port ``SimState`` (tensors or numpy, any
    leading axes) as numpy, under the reference's names."""
    n = lambda x: x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)
    c, h, net = sim.containers, sim.hosts, sim.net
    out = {"c." + k: n(getattr(c, k)) for k in c._fields}
    out.update({"h.used": n(h.used), "h.n": n(h.n_containers),
                "h.busy": n(h.busy_time), "net.link_util": n(net.link_util),
                "net.delay_matrix": n(net.delay_matrix),
                "net.comm_cost": n(net.comm_cost),
                "total_cost": n(sim.total_cost), "t": n(sim.t),
                "rr": n(sim.sched.rr_pointer)})
    return out


def summary_to_dict(online) -> dict:
    return {k: np.asarray(v) for k, v in online._asdict().items()}


def build_kernels(sim: dict) -> list:
    """Build with nvcc the simulator kernels a tick launches that the
    checkout has not built yet (``fw_minplus`` in ``'fw'`` delay mode,
    ``seg_waterfill``); returns the names built."""
    port()
    from repro_torch.kernels import _build
    names = ["seg_waterfill"] + (["fw_minplus"]
                                 if sim["delay_mode"] == "fw" else [])
    todo = [n for n in names if not _build.library_path(n).exists()]
    _build.build(todo)
    return todo
