"""Data collection module (paper §3.7): per-tick metric extraction.

Counterpart of ``repro.core.stats``: :func:`collect` (one tick's
``TickMetrics``, stacked by ``engine.run_sim``), the streaming
accumulator (``SummaryAcc`` on the device, reset every chunk:
:func:`acc_init`, :func:`acc_update`) and its host-side f64/i64 fold
(:func:`online_init`, :func:`online_fold`, :func:`online_merge`), and
:func:`online_from_metrics`, the same summary from a stacked series.
The tick stays f32/i32; the only 64-bit arithmetic is the numpy fold.
:func:`soft_num_den` and :func:`soft_objective` reduce the soft-placement
surrogate sums (``SimConfig.soft_placement``) of any of the three shapes
to the objective autograd differentiates.  :func:`acc_update_weighted`
folds ``dt`` identical ticks at once, for the telescoping engine's
skipped ticks (``engine.simulate_telescoped``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import (
    STATUS_COMMUNICATING, STATUS_COMPLETED, STATUS_INACTIVE, STATUS_MIGRATING,
    STATUS_RUNNING, STATUS_WAITING, OnlineSummary, RunParams, SimState,
    SummaryAcc, TickMetrics, resolve_device,
)
from repro_torch.core import trace

F32 = torch.float32
I32 = torch.int32


def collect(sim: SimState, new_arrivals: torch.Tensor,
            decisions: torch.Tensor, migrations: torch.Tensor,
            params: RunParams, flow_active: torch.Tensor,
            flow_rates: torch.Tensor, soft=None) -> TickMetrics:
    """Per-tick metrics; ``params`` carries the overload threshold the
    ``n_overloaded`` count is judged against.  ``soft`` is the scheduling
    round's surrogate 5-tuple ``(soft_comm, soft_util, soft_n, soft_mig,
    soft_mig_n)`` from ``engine.phase_schedule_soft``; omitted, the five
    are 0.0."""
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
    if soft is None:
        soft = (torch.zeros((), dtype=F32, device=st.device),) * 5
    soft_comm, soft_util, soft_n, soft_mig, soft_mig_n = soft
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
        soft_comm=soft_comm, soft_util=soft_util, soft_n=soft_n,
        soft_mig=soft_mig, soft_mig_n=soft_mig_n,
    )


# ---------------------------------------------------------------------------
# Streaming accumulation: SummaryAcc (device, per chunk) -> OnlineSummary
# (host, f64/i64, whole run)
# ---------------------------------------------------------------------------
def max_chunk_ticks(n_containers: int) -> int:
    """Largest chunk whose i32 accumulator sums cannot overflow: the
    fastest-growing counted series is ``active_flows``, at most 2C a
    tick."""
    return (2**31 - 1) // max(2 * n_containers, 1)


def check_chunk(chunk: int, n_containers: int) -> None:
    limit = max_chunk_ticks(n_containers)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if chunk > limit:
        raise ValueError(
            f"chunk={chunk} can overflow i32 accumulator sums at "
            f"C={n_containers} containers (2C flows/tick); use "
            f"chunk <= {limit} — the host-side fold promotes to i64 "
            f"between chunks, so total horizon is unbounded")


# SummaryAcc fields by dtype, in field order (the one-copy host transfer
# of acc_to_numpy packs them so)
ACC_INT_FIELDS = ("n_ticks", "sum_active_flows", "sum_arrivals",
                  "sum_decisions", "sum_migrations", "peak_running",
                  "peak_deployed", "peak_overloaded", "peak_inactive")
ACC_FLOAT_FIELDS = tuple(f for f in SummaryAcc._fields
                         if f not in ACC_INT_FIELDS)


def acc_init(device=None) -> SummaryAcc:
    """Zero accumulator on ``device`` (peaks start at 0: every counted
    series is >= 0); every field is its own tensor."""
    dev = resolve_device(device)
    return SummaryAcc(**{
        f: torch.zeros((), dtype=I32 if f in ACC_INT_FIELDS else F32,
                       device=dev)
        for f in SummaryAcc._fields})


def _kahan(s, c, x):
    """One compensated-summation step: returns (s', c')."""
    y = x - c
    t = s + y
    return t, (t - s) - y


def acc_update(acc: SummaryAcc, m: TickMetrics) -> SummaryAcc:
    """Fold one tick's metrics into the accumulator: f32 sums
    Kahan-compensated, ``mean_util`` also into a Welford (mean, M2) pair,
    integer sums in i32 (exact under ``max_chunk_ticks``); the f32
    operations in the JAX package's order."""
    su, cu = _kahan(acc.sum_util_var, acc.c_util_var, m.util_variance)
    sm, cm = _kahan(acc.sum_mean_util, acc.c_mean_util, m.mean_util)
    sf, cf = _kahan(acc.sum_flow_rate, acc.c_flow_rate, m.mean_flow_rate)
    ssc, csc = _kahan(acc.sum_soft_comm, acc.c_soft_comm, m.soft_comm)
    ssu, csu = _kahan(acc.sum_soft_util, acc.c_soft_util, m.soft_util)
    ssn, csn = _kahan(acc.sum_soft_n, acc.c_soft_n, m.soft_n)
    ssm, csm = _kahan(acc.sum_soft_mig, acc.c_soft_mig, m.soft_mig)
    ssmn, csmn = _kahan(acc.sum_soft_mig_n, acc.c_soft_mig_n, m.soft_mig_n)
    n = acc.n_ticks + 1
    delta = m.mean_util - acc.w_mean_util
    w_mean = acc.w_mean_util + delta / n.to(F32)
    w_m2 = acc.w_m2_util + delta * (m.mean_util - w_mean)
    return SummaryAcc(
        n_ticks=n,
        sum_util_var=su, c_util_var=cu,
        sum_mean_util=sm, c_mean_util=cm,
        sum_flow_rate=sf, c_flow_rate=cf,
        w_mean_util=w_mean, w_m2_util=w_m2,
        sum_active_flows=acc.sum_active_flows + m.active_flows.to(I32),
        sum_arrivals=acc.sum_arrivals + m.new_arrivals.to(I32),
        sum_decisions=acc.sum_decisions + m.decisions.to(I32),
        sum_migrations=acc.sum_migrations + m.migrations.to(I32),
        peak_running=torch.maximum(acc.peak_running, m.n_running),
        peak_deployed=torch.maximum(acc.peak_deployed, m.n_deployed),
        peak_overloaded=torch.maximum(acc.peak_overloaded, m.n_overloaded),
        peak_inactive=torch.maximum(acc.peak_inactive, m.n_inactive),
        sum_soft_comm=ssc, c_soft_comm=csc,
        sum_soft_util=ssu, c_soft_util=csu,
        sum_soft_n=ssn, c_soft_n=csn,
        sum_soft_mig=ssm, c_soft_mig=csm,
        sum_soft_mig_n=ssmn, c_soft_mig_n=csmn,
    )


def acc_update_weighted(acc: SummaryAcc, m: TickMetrics,
                        dt: torch.Tensor) -> SummaryAcc:
    """Fold ``dt`` identical ticks' metrics into the accumulator at once
    (``dt`` an i32 0-d tensor on the accumulator's device): the
    telescoping engine's fold of a quiescent interval, whose per-tick
    metrics are constant.  Each Kahan pair takes ``w * x`` in one step,
    the Welford pair Chan's merge of ``dt`` equal values (ratio first,
    ``w / max(n, 1)``), the i32 sums ``dt * v`` (exact under
    ``max_chunk_ticks``) and the peaks ``maximum``; the f32 operations in
    the JAX package's order.  Integer fields equal ``dt`` repeated
    :func:`acc_update` calls, float ones agree to ~1 ulp.  ``dt == 0``
    keeps every field bit for bit (a Kahan step of 0.0 would still fold
    the compensation into the sum)."""
    w = dt.to(F32)
    su, cu = _kahan(acc.sum_util_var, acc.c_util_var, w * m.util_variance)
    sm, cm = _kahan(acc.sum_mean_util, acc.c_mean_util, w * m.mean_util)
    sf, cf = _kahan(acc.sum_flow_rate, acc.c_flow_rate, w * m.mean_flow_rate)
    ssc, csc = _kahan(acc.sum_soft_comm, acc.c_soft_comm, w * m.soft_comm)
    ssu, csu = _kahan(acc.sum_soft_util, acc.c_soft_util, w * m.soft_util)
    ssn, csn = _kahan(acc.sum_soft_n, acc.c_soft_n, w * m.soft_n)
    ssm, csm = _kahan(acc.sum_soft_mig, acc.c_soft_mig, w * m.soft_mig)
    ssmn, csmn = _kahan(acc.sum_soft_mig_n, acc.c_soft_mig_n,
                        w * m.soft_mig_n)
    n = acc.n_ticks + dt.to(I32)
    nf = torch.clamp(n.to(F32), min=1.0)
    delta = m.mean_util - acc.w_mean_util
    w_mean = acc.w_mean_util + delta * (w / nf)
    w_m2 = acc.w_m2_util + delta * delta * (acc.n_ticks.to(F32) * w / nf)
    new = SummaryAcc(
        n_ticks=n,
        sum_util_var=su, c_util_var=cu,
        sum_mean_util=sm, c_mean_util=cm,
        sum_flow_rate=sf, c_flow_rate=cf,
        w_mean_util=w_mean, w_m2_util=w_m2,
        sum_active_flows=(acc.sum_active_flows
                          + dt * m.active_flows.to(I32)),
        sum_arrivals=acc.sum_arrivals + dt * m.new_arrivals.to(I32),
        sum_decisions=acc.sum_decisions + dt * m.decisions.to(I32),
        sum_migrations=acc.sum_migrations + dt * m.migrations.to(I32),
        peak_running=torch.maximum(acc.peak_running, m.n_running),
        peak_deployed=torch.maximum(acc.peak_deployed, m.n_deployed),
        peak_overloaded=torch.maximum(acc.peak_overloaded, m.n_overloaded),
        peak_inactive=torch.maximum(acc.peak_inactive, m.n_inactive),
        sum_soft_comm=ssc, c_soft_comm=csc,
        sum_soft_util=ssu, c_soft_util=csu,
        sum_soft_n=ssn, c_soft_n=csn,
        sum_soft_mig=ssm, c_soft_mig=csm,
        sum_soft_mig_n=ssmn, c_soft_mig_n=csmn,
    )
    keep = dt > 0
    return SummaryAcc(*(torch.where(keep, upd, old)
                        for old, upd in zip(acc, new)))


def acc_to_numpy(acc: SummaryAcc) -> SummaryAcc:
    """The accumulator's leaves (tensors of any one shape) as numpy arrays,
    with ONE device-to-host copy: the i32 fields ride the f32 stack as
    their bit patterns.  Numpy leaves pass through; the values of soft
    sums that carry a graph are taken, the graph left alone.  Under a
    profiler the copy's decisions are counted as ``admitted``
    (``core/trace.py``)."""
    if not isinstance(acc.n_ticks, torch.Tensor):
        return SummaryAcc(*(np.asarray(x) for x in acc))
    f = torch.stack([getattr(acc, k) for k in ACC_FLOAT_FIELDS]).detach()
    i = torch.stack([getattr(acc, k) for k in ACC_INT_FIELDS])
    with trace.host_sync("summary_copy"):
        host = torch.cat([f, i.view(F32)]).cpu().numpy()
    nf = len(ACC_FLOAT_FIELDS)
    vals = dict(zip(ACC_FLOAT_FIELDS, host[:nf]))
    vals.update(zip(ACC_INT_FIELDS, host[nf:].view(np.int32)))
    trace.count("admitted", int(vals["sum_decisions"].sum(dtype=np.int64)))
    return SummaryAcc(**vals)


def online_init(batch_shape: tuple = ()) -> OnlineSummary:
    """Empty host-side summary (f64/i64, optional leading batch axes).
    Every field gets its OWN buffer: the streamed sweep writes summaries
    slab by slab into slices, so shared zero arrays would alias fields."""
    z_i = lambda: np.zeros(batch_shape, np.int64)
    z_f = lambda: np.zeros(batch_shape, np.float64)
    return OnlineSummary(
        n_ticks=z_i(), sum_util_var=z_f(), sum_mean_util=z_f(),
        sum_flow_rate=z_f(), w_mean_util=z_f(), w_m2_util=z_f(),
        sum_active_flows=z_i(), sum_arrivals=z_i(), sum_decisions=z_i(),
        sum_migrations=z_i(), peak_running=z_i(), peak_deployed=z_i(),
        peak_overloaded=z_i(), peak_inactive=z_i(),
        sum_soft_comm=z_f(), sum_soft_util=z_f(), sum_soft_n=z_f(),
        sum_soft_mig=z_f(), sum_soft_mig_n=z_f(),
    )


def online_fold(host: OnlineSummary, acc: SummaryAcc) -> OnlineSummary:
    """Fold one finished chunk into the host summary: a Kahan pair folds
    as ``f64(s) + f64(c)``, the per-chunk Welford moments merge by Chan's
    parallel-combine rule.  ``acc`` may hold tensors (one host copy,
    :func:`acc_to_numpy`) or numpy arrays; broadcasts over leading batch
    axes."""
    a = acc_to_numpy(acc)
    na = host.n_ticks.astype(np.float64)
    nb = a.n_ticks.astype(np.float64)
    n = na + nb
    safe_n = np.where(n > 0, n, 1.0)
    delta = a.w_mean_util.astype(np.float64) - host.w_mean_util
    w_mean = host.w_mean_util + delta * nb / safe_n
    w_m2 = (host.w_m2_util + a.w_m2_util.astype(np.float64)
            + delta * delta * na * nb / safe_n)
    f64 = lambda s, c: s.astype(np.float64) + c.astype(np.float64)
    i64 = lambda x: x.astype(np.int64)
    return OnlineSummary(
        n_ticks=host.n_ticks + i64(a.n_ticks),
        sum_util_var=host.sum_util_var + f64(a.sum_util_var, a.c_util_var),
        sum_mean_util=(host.sum_mean_util
                       + f64(a.sum_mean_util, a.c_mean_util)),
        sum_flow_rate=(host.sum_flow_rate
                       + f64(a.sum_flow_rate, a.c_flow_rate)),
        w_mean_util=w_mean, w_m2_util=w_m2,
        sum_active_flows=host.sum_active_flows + i64(a.sum_active_flows),
        sum_arrivals=host.sum_arrivals + i64(a.sum_arrivals),
        sum_decisions=host.sum_decisions + i64(a.sum_decisions),
        sum_migrations=host.sum_migrations + i64(a.sum_migrations),
        peak_running=np.maximum(host.peak_running, i64(a.peak_running)),
        peak_deployed=np.maximum(host.peak_deployed, i64(a.peak_deployed)),
        peak_overloaded=np.maximum(host.peak_overloaded,
                                   i64(a.peak_overloaded)),
        peak_inactive=np.maximum(host.peak_inactive, i64(a.peak_inactive)),
        sum_soft_comm=(host.sum_soft_comm
                       + f64(a.sum_soft_comm, a.c_soft_comm)),
        sum_soft_util=(host.sum_soft_util
                       + f64(a.sum_soft_util, a.c_soft_util)),
        sum_soft_n=host.sum_soft_n + f64(a.sum_soft_n, a.c_soft_n),
        sum_soft_mig=(host.sum_soft_mig
                      + f64(a.sum_soft_mig, a.c_soft_mig)),
        sum_soft_mig_n=(host.sum_soft_mig_n
                        + f64(a.sum_soft_mig_n, a.c_soft_mig_n)),
    )


def online_merge(a: OnlineSummary, b: OnlineSummary) -> OnlineSummary:
    """Merge two host-side summaries (both f64/i64) by the same Chan rule;
    associative, and exact on all-zero cells (``online_init``), so merging
    partials of disjoint cells reproduces the whole grid's summary bit for
    bit.  Broadcasts over leading batch axes."""
    na = a.n_ticks.astype(np.float64)
    nb = b.n_ticks.astype(np.float64)
    n = na + nb
    safe_n = np.where(n > 0, n, 1.0)
    delta = b.w_mean_util - a.w_mean_util
    # the ratios are formed FIRST: on an empty side nb/n is exactly 1.0 or
    # 0.0, so the delta term collapses bitwise
    w_mean = a.w_mean_util + delta * (nb / safe_n)
    w_m2 = (a.w_m2_util + b.w_m2_util
            + delta * delta * (na * nb / safe_n))
    return OnlineSummary(
        n_ticks=a.n_ticks + b.n_ticks,
        sum_util_var=a.sum_util_var + b.sum_util_var,
        sum_mean_util=a.sum_mean_util + b.sum_mean_util,
        sum_flow_rate=a.sum_flow_rate + b.sum_flow_rate,
        w_mean_util=w_mean, w_m2_util=w_m2,
        sum_active_flows=a.sum_active_flows + b.sum_active_flows,
        sum_arrivals=a.sum_arrivals + b.sum_arrivals,
        sum_decisions=a.sum_decisions + b.sum_decisions,
        sum_migrations=a.sum_migrations + b.sum_migrations,
        peak_running=np.maximum(a.peak_running, b.peak_running),
        peak_deployed=np.maximum(a.peak_deployed, b.peak_deployed),
        peak_overloaded=np.maximum(a.peak_overloaded, b.peak_overloaded),
        peak_inactive=np.maximum(a.peak_inactive, b.peak_inactive),
        sum_soft_comm=a.sum_soft_comm + b.sum_soft_comm,
        sum_soft_util=a.sum_soft_util + b.sum_soft_util,
        sum_soft_n=a.sum_soft_n + b.sum_soft_n,
        sum_soft_mig=a.sum_soft_mig + b.sum_soft_mig,
        sum_soft_mig_n=a.sum_soft_mig_n + b.sum_soft_mig_n,
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


# ---------------------------------------------------------------------------
# Differentiable surrogate objectives (SimConfig.soft_placement)
# ---------------------------------------------------------------------------
# name -> which surrogate sums form the mean; 'soft_blend' mixes the comm-
# and util-expectation columns (a single-column objective is invariant to
# scaling its one weight).  Lower = better.
SOFT_OBJECTIVES: tuple = ("soft_blend", "soft_comm", "soft_util",
                          "soft_mig_util")


def soft_num_den(m, objective: str = "soft_blend"):
    """(numerator, denominator) of a named surrogate objective.  ``m`` may
    be stacked ``TickMetrics`` (trailing time axis, summed here), a
    ``SummaryAcc`` (the Kahan pair collapsed as ``sum + c``, as
    ``online_fold`` recovers it) or a host-side ``OnlineSummary``; on
    tensors it stays differentiable."""
    if objective not in SOFT_OBJECTIVES:
        raise KeyError(f"unknown soft objective {objective!r}; known: "
                       f"{list(SOFT_OBJECTIVES)}")
    if isinstance(m, SummaryAcc):
        comm = m.sum_soft_comm + m.c_soft_comm
        util = m.sum_soft_util + m.c_soft_util
        n = m.sum_soft_n + m.c_soft_n
        mig = m.sum_soft_mig + m.c_soft_mig
        mig_n = m.sum_soft_mig_n + m.c_soft_mig_n
    elif isinstance(m, OnlineSummary):
        comm, util, n = m.sum_soft_comm, m.sum_soft_util, m.sum_soft_n
        mig, mig_n = m.sum_soft_mig, m.sum_soft_mig_n
    elif isinstance(m, TickMetrics):
        comm = m.soft_comm.sum(-1)
        util = m.soft_util.sum(-1)
        n = m.soft_n.sum(-1)
        mig = m.soft_mig.sum(-1)
        mig_n = m.soft_mig_n.sum(-1)
    else:
        raise TypeError(f"expected TickMetrics, SummaryAcc or "
                        f"OnlineSummary, got {type(m).__name__}")
    if objective == "soft_comm":
        return comm, n
    if objective == "soft_util":
        return util, n
    if objective == "soft_mig_util":
        return mig, mig_n
    return comm + util, n


def soft_objective(m, objective: str = "soft_blend"):
    """Mean surrogate cost (lower = better): numerator / max(count, 1).
    The count comes from feasibility decisions, piecewise constant in the
    weights, so the gradient is the numerator's scaled by it."""
    num, den = soft_num_den(m, objective)
    if isinstance(den, torch.Tensor):
        return num / torch.clamp(den, min=1.0)
    return num / np.maximum(den, 1.0)
