"""Data center module (paper §3.3): hosts + config (paper Tables 5/6).

Counterpart of ``repro.core.datacenter``; the host tables are built on the
host with numpy and moved to the requested device once.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import network
from repro_torch.core.types import (HostState, RunParams, make_hosts,
                                    resolve_device)


@dataclasses.dataclass(frozen=True)
class HostCategory:
    """One row of paper Table 5."""

    count: int
    cpu_cores: int      # cores; capacity = cores * 100 (percent units)
    cpu_speed: float
    mem_gb: int
    mem_speed: float
    gpu_count: int      # GPUs; capacity = gpus * 100 (percent units)
    gpu_speed: float
    price: float


# Paper Table 5 — four heterogeneous host classes, five hosts each.
PAPER_HOST_CATEGORIES: tuple[HostCategory, ...] = (
    HostCategory(5, 80, 1.0, 128, 1.0, 8, 1.0, 1.0),
    HostCategory(5, 80, 2.0, 128, 2.0, 8, 2.0, 1.5),
    HostCategory(5, 80, 3.0, 128, 3.0, 8, 3.0, 3.0),
    HostCategory(5, 80, 4.0, 128, 4.0, 8, 4.0, 5.0),
)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Simulator parameters (paper Table 6), the same fields and defaults as
    ``repro.core.datacenter.SimConfig``.  Knobs a sweep varies at run time
    live in :class:`~repro_torch.core.types.RunParams`; the copies here are
    the defaults :meth:`run_params` reads."""

    # workload
    n_jobs: int = 100
    n_tasks: int = 300
    n_containers: int = 300
    duration_range: tuple[float, float] = (20.0, 30.0)
    cpu_req_range: tuple[float, float] = (100.0, 1700.0)   # percent
    mem_req_range: tuple[float, float] = (1.0, 32.0)       # GB
    gpu_req_range: tuple[float, float] = (50.0, 200.0)     # percent
    n_comms_range: tuple[int, int] = (1, 5)
    comm_kb_range: tuple[float, float] = (100.0, 102400.0)  # KB per comm
    arrival_window: float = 36.0   # jobs arrive uniformly in [0, window)
    # simulator
    delay_update_interval: int = 10   # ticks between delay-matrix refreshes
    max_retries: int = 3              # iperf retransmission cap
    congestion_threshold: float = 0.2
    max_containers_per_host: int = 10  # network nodes allocated per host
    overload_threshold: float = 0.7
    idle_threshold: float = 0.3
    # engine
    horizon: int = 120                # simulated seconds
    placements_per_tick: int = 64     # admit-round length
    migrations_per_tick: int = 8
    waterfill_rounds: int = 8
    delay_mode: str = "path"          # 'path' | 'fw'
    # kernel selectors ('auto' | 'on' | 'off', repro_torch.kernels.
    # resolve_kernel): the CUDA kernel on a CUDA device and the plain
    # PyTorch version on the CPU under 'auto'
    delay_kernel: str = "auto"        # fw_minplus APSP ('fw' delay mode)
    waterfill_kernel: str = "auto"    # seg_waterfill flow allocation
    sparse_flows: bool = True         # segment-based flow engine
    batched_placement: bool = True    # conflict-resolved top-K admit round
    # sum the softmax surrogate of each schedule round beside the hard
    # decisions (launch.sweep.make_grad_fn differentiates it); needs
    # batched_placement
    soft_placement: bool = False
    tau: float = 1.0                  # RunParams.tau default
    stall_rate_floor: float = 50.0    # KB/s under which a flow is 'stalled'
    mig_kb_per_gb: float = 1024.0     # migration bytes per GB of memory req
    queue_coef: float = 0.5           # RunParams default

    def run_params(self, device=None) -> RunParams:
        """Default runtime parameters; ``bw_mbps``/``loss`` hold their
        keep-the-topology sentinels."""
        device = resolve_device(device)
        f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
        return RunParams(
            bw_mbps=f32(-1.0), loss=f32(-1.0),
            queue_coef=f32(self.queue_coef),
            overload_threshold=f32(self.overload_threshold),
            idle_threshold=f32(self.idle_threshold),
            tau=f32(self.tau),
        )


def build_paper_hosts(categories: Sequence[HostCategory] = PAPER_HOST_CATEGORIES,
                      n_leaf: int = 4, device=None) -> HostState:
    rows_cap, rows_speed, price = [], [], []
    for cat in categories:
        for _ in range(cat.count):
            rows_cap.append([cat.cpu_cores * 100.0, float(cat.mem_gb),
                             cat.gpu_count * 100.0])
            rows_speed.append([cat.cpu_speed, cat.mem_speed, cat.gpu_speed])
            price.append(cat.price)
    cap = np.asarray(rows_cap, np.float32)
    speed = np.asarray(rows_speed, np.float32)
    price_a = np.asarray(price, np.float32)
    H = cap.shape[0]
    leaf = (np.arange(H) % n_leaf).astype(np.int32)
    return make_hosts(cap, speed, price_a, leaf, device=device)


def scaled_hosts(n_hosts: int, n_leaf: int,
                 categories: Sequence[HostCategory] = PAPER_HOST_CATEGORIES,
                 device=None) -> HostState:
    """Round-robin the paper's categories up to ``n_hosts`` (Table 7)."""
    per = max(1, n_hosts // len(categories))
    cats = [dataclasses.replace(cat, count=per) for cat in categories]
    rem = n_hosts - per * len(categories)
    if rem > 0:   # the remainder goes to the first category
        cats[0] = dataclasses.replace(cats[0], count=per + rem)
    return build_paper_hosts(tuple(cats), n_leaf=n_leaf, device=device)


# Heterogeneous host price/capacity mixes (same table as the JAX package).
HOST_MIXES: dict[str, tuple[HostCategory, ...]] = {
    "paper": PAPER_HOST_CATEGORIES,
    "budget": (HostCategory(20, 80, 1.0, 128, 1.0, 8, 1.0, 1.0),),
    "premium": (
        HostCategory(15, 80, 1.0, 128, 1.0, 8, 1.0, 1.0),
        HostCategory(5, 80, 4.0, 256, 4.0, 8, 4.0, 8.0),
    ),
    "contrast": (
        HostCategory(10, 40, 1.0, 64, 1.0, 4, 1.0, 0.5),
        HostCategory(10, 160, 3.0, 256, 3.0, 16, 3.0, 6.0),
    ),
}


def mixed_hosts(mix: str, n_hosts: int, n_leaf: int,
                device=None) -> HostState:
    """Build ``n_hosts`` hosts from a named :data:`HOST_MIXES` entry."""
    try:
        cats = HOST_MIXES[mix]
    except KeyError:
        raise KeyError(
            f"unknown host mix {mix!r}; known: {sorted(HOST_MIXES)}") from None
    return scaled_hosts(n_hosts, n_leaf, cats, device=device)


def build_paper_network(cfg: SimConfig, n_hosts: int = 20, n_spine: int = 2,
                        n_leaf: int = 4, bw: float = 1000.0,
                        loss: float = 0.0, device=None):
    spec = network.SpineLeafSpec(
        n_spine=n_spine, n_leaf=n_leaf, n_hosts=n_hosts,
        host_leaf_bw=bw, leaf_spine_bw=bw, loss=loss)
    return spec, network.build_network(spec, device=device)
