"""Scenario layer: declarative sweep points -> simulator inputs.

Counterpart of ``repro.core.scenario``.  A :class:`ScenarioSpec` names
everything one cell of a sweep varies — link bandwidth/loss, arrival
pattern, host price/capacity mix, runtime thresholds — without touching
any shape.  The builders turn a list of specs into two stacked inputs on
one device:

* a ``SimState`` with leading axes ``[S, N]`` (scenario x seed): hosts,
  workload and base network;
* a ``RunParams`` with leading axis ``[S]``: the bw/loss overrides and
  the runtime knobs, applied inside ``engine.simulate`` at t = 0.

``repro_torch.launch.sweep`` runs the policy x scenario x seed grid over
them one cell at a time.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from repro_torch.core.datacenter import SimConfig, mixed_hosts
from repro_torch.core.engine import init_sim
from repro_torch.core.network import SpineLeafSpec, build_network
from repro_torch.core.types import RunParams, resolve_device, tree_map
from repro_torch.core.workload import (bursty_workload, paper_workload,
                                       trace_workload)

ARRIVALS: dict[str, Callable] = {
    "paper": paper_workload,
    "trace": trace_workload,
    "bursty": bursty_workload,
}


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One sweep point.  ``None`` keeps the config/topology default: it
    maps onto the ``RunParams`` keep-sentinels (``bw <= 0``, ``loss <
    0``), so every spec gives the same structure and a ladder stacks."""

    name: str
    bw: float | None = None            # uniform link bandwidth (Mbps)
    loss: float | None = None          # uniform link loss fraction
    arrival: str = "paper"             # paper | trace | bursty
    host_mix: str = "paper"            # datacenter.HOST_MIXES key
    queue_coef: float | None = None
    overload_threshold: float | None = None
    idle_threshold: float | None = None
    tau: float | None = None           # soft-placement temperature override

    def __post_init__(self):
        # values inside the keep-sentinel domain would silently not
        # override: reject them
        if self.bw is not None and self.bw <= 0:
            raise ValueError(f"{self.name}: bw must be > 0 Mbps, "
                             f"got {self.bw}")
        if self.loss is not None and self.loss < 0:
            raise ValueError(f"{self.name}: loss must be >= 0, "
                             f"got {self.loss}")
        if self.arrival not in ARRIVALS:
            raise KeyError(f"{self.name}: unknown arrival "
                           f"{self.arrival!r}; known: {sorted(ARRIVALS)}")
        if self.tau is not None and self.tau <= 0:
            raise ValueError(f"{self.name}: tau must be > 0, got {self.tau}")

    def run_params(self, cfg: SimConfig, device=None) -> RunParams:
        """The spec's ``RunParams``: 0-d f32 tensors on ``device``."""
        base = cfg.run_params(device)
        f32 = lambda v, dflt: dflt if v is None else torch.tensor(
            v, dtype=torch.float32, device=dflt.device)
        return RunParams(
            bw_mbps=f32(self.bw, base.bw_mbps),
            loss=f32(self.loss, base.loss),
            queue_coef=f32(self.queue_coef, base.queue_coef),
            overload_threshold=f32(self.overload_threshold,
                                   base.overload_threshold),
            idle_threshold=f32(self.idle_threshold, base.idle_threshold),
            tau=f32(self.tau, base.tau),
        )


def default_scenarios() -> list[ScenarioSpec]:
    """The paper's evaluation grid as data: a healthy fabric, the Fig 5/8
    degraded-network ladder, a flash-crowd arrival process and a
    heterogeneous-fleet price/capacity mix."""
    return [
        ScenarioSpec("baseline"),
        ScenarioSpec("slow_net", bw=200.0),
        ScenarioSpec("lossy_net", bw=500.0, loss=0.02),
        ScenarioSpec("bursty", arrival="bursty"),
        ScenarioSpec("premium_hosts", host_mix="premium"),
    ]


def stack_tree(trees):
    """Stack a list of same-structure state tuples leaf by leaf along a new
    leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def build_scenario(spec: ScenarioSpec, cfg: SimConfig, n_hosts: int = 20,
                   n_spine: int = 2, n_leaf: int = 4,
                   seeds: Sequence[int] = (0,), net=None, device=None):
    """One scenario -> (SpineLeafSpec, SimState stacked over seeds [N, ...],
    RunParams) on ``device``.  The network is built at topology defaults;
    the spec's bw/loss ride the RunParams.  ``net`` shares one built
    topology across scenarios.  A seed draws the workload only."""
    device = resolve_device(device)
    net_spec = SpineLeafSpec(n_spine=n_spine, n_leaf=n_leaf, n_hosts=n_hosts)
    net = build_network(net_spec, device=device) if net is None else net
    hosts = mixed_hosts(spec.host_mix, n_hosts, n_leaf, device=device)
    gen = ARRIVALS[spec.arrival]
    sims = [init_sim(hosts, gen(cfg, seed=s, device=device), net)
            for s in seeds]
    return net_spec, stack_tree(sims), spec.run_params(cfg, device)


def build_scenarios(specs: Sequence[ScenarioSpec], cfg: SimConfig,
                    n_hosts: int = 20, n_spine: int = 2, n_leaf: int = 4,
                    seeds: Sequence[int] = (0,), device=None):
    """Scenario list -> (SpineLeafSpec, SimState [S, N, ...], RunParams
    [S]) on ``device``.  Every spec shares the topology shape, and the
    O(H^2) topology build happens once."""
    device = resolve_device(device)
    net_spec = SpineLeafSpec(n_spine=n_spine, n_leaf=n_leaf,
                             n_hosts=n_hosts)
    net = build_network(net_spec, device=device)
    sims, params = [], []
    for spec in specs:
        _, sim, rp = build_scenario(spec, cfg, n_hosts=n_hosts,
                                    n_spine=n_spine, n_leaf=n_leaf,
                                    seeds=seeds, net=net, device=device)
        sims.append(sim)
        params.append(rp)
    return net_spec, stack_tree(sims), stack_tree(params)
