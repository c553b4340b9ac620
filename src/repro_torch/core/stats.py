"""Data collection module (paper §3.7): per-tick metric extraction.

Counterpart of ``repro.core.stats`` for this slice: :func:`collect` (one
tick's ``TickMetrics``, stacked by ``engine.run_sim``) and
:func:`online_from_metrics`, the host-side f64/i64 fold of the stacked
series that ``report.summarize`` reads.  The streaming accumulators come
with the streaming slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import (
    STATUS_COMMUNICATING, STATUS_COMPLETED, STATUS_INACTIVE, STATUS_MIGRATING,
    STATUS_RUNNING, STATUS_WAITING, OnlineSummary, RunParams, SimState,
    TickMetrics,
)

F32 = torch.float32
I32 = torch.int32


def collect(sim: SimState, new_arrivals: torch.Tensor,
            decisions: torch.Tensor, migrations: torch.Tensor,
            params: RunParams, flow_active: torch.Tensor,
            flow_rates: torch.Tensor) -> TickMetrics:
    """Per-tick metrics; ``params`` carries the overload threshold the
    ``n_overloaded`` count is judged against."""
    st = sim.containers.status
    util = sim.hosts.used / torch.clamp(sim.hosts.cap, min=1e-6)    # [H, 3]
    worst = util.amax(dim=1)
    mean_util = ((util[:, 0] + util[:, 1]) + util[:, 2]) / 3.0      # per host
    n_active_flows = flow_active.sum().to(I32)
    mean_rate = torch.where(
        n_active_flows > 0,
        (flow_rates * flow_active).sum()
        / torch.clamp(n_active_flows, min=1).to(F32), 0.0)
    codes = torch.tensor([STATUS_INACTIVE, STATUS_RUNNING,
                          STATUS_COMMUNICATING, STATUS_MIGRATING,
                          STATUS_WAITING, STATUS_COMPLETED],
                         dtype=st.dtype, device=st.device)
    counts = (st[:, None] == codes[None, :]).sum(dim=0).to(I32)
    n_inactive, n_running, n_comm, n_mig, n_wait, n_done = counts.unbind()
    zero = torch.zeros((), dtype=F32, device=st.device)
    return TickMetrics(
        t=sim.t,
        n_overloaded=(worst > params.overload_threshold).sum().to(I32),
        n_inactive=n_inactive + n_wait,
        n_running=n_running,
        n_deployed=n_running + n_comm + n_mig,
        n_communicating=n_comm,
        n_waiting=n_wait,
        n_completed=n_done,
        n_migrating=n_mig,
        new_arrivals=new_arrivals.to(I32),
        decisions=decisions,
        migrations=migrations,
        util_variance=torch.var(mean_util, correction=0),
        mean_util=mean_util.mean(),
        active_flows=n_active_flows,
        mean_flow_rate=mean_rate,
        soft_comm=zero, soft_util=zero, soft_n=zero, soft_mig=zero,
        soft_mig_n=zero,
    )


def online_from_metrics(metrics: TickMetrics) -> OnlineSummary:
    """The run's summary from a full [..., T] ``TickMetrics`` series, in
    f64/i64 on the host (the JAX package's ``online_from_metrics``)."""
    def np_(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    f = lambda x: np_(x).astype(np.float64)
    i = lambda x: np_(x).astype(np.int64)
    mu = f(metrics.mean_util)
    n = np.full(mu.shape[:-1], mu.shape[-1], np.int64)
    w_mean = mu.mean(axis=-1) if mu.shape[-1] else np.zeros(mu.shape[:-1])
    w_m2 = ((mu - w_mean[..., None]) ** 2).sum(axis=-1)
    return OnlineSummary(
        n_ticks=n,
        sum_util_var=f(metrics.util_variance).sum(axis=-1),
        sum_mean_util=mu.sum(axis=-1),
        sum_flow_rate=f(metrics.mean_flow_rate).sum(axis=-1),
        w_mean_util=w_mean, w_m2_util=w_m2,
        sum_active_flows=i(metrics.active_flows).sum(axis=-1),
        sum_arrivals=i(metrics.new_arrivals).sum(axis=-1),
        sum_decisions=i(metrics.decisions).sum(axis=-1),
        sum_migrations=i(metrics.migrations).sum(axis=-1),
        peak_running=i(metrics.n_running).max(axis=-1),
        peak_deployed=i(metrics.n_deployed).max(axis=-1),
        peak_overloaded=i(metrics.n_overloaded).max(axis=-1),
        peak_inactive=i(metrics.n_inactive).max(axis=-1),
        sum_soft_comm=f(metrics.soft_comm).sum(axis=-1),
        sum_soft_util=f(metrics.soft_util).sum(axis=-1),
        sum_soft_n=f(metrics.soft_n).sum(axis=-1),
        sum_soft_mig=f(metrics.soft_mig).sum(axis=-1),
        sum_soft_mig_n=f(metrics.soft_mig_n).sum(axis=-1),
    )
