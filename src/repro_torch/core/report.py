"""Analysis-report module (paper §3.7): end-of-run evaluation metrics.

Counterpart of ``repro.core.report`` for this slice: the run summary
(average response time, runtime, cost and the metrics-derived keys), the
per-tick series as plain numpy and its CSV export.  Host-side numpy only.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.stats import online_from_metrics
from repro_torch.core.types import (STATUS_COMPLETED, OnlineSummary,
                                    SimState, TickMetrics)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def json_clean(obj):
    """Recursively replace non-finite floats with None so summary rows
    serialize to strictly valid JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: json_clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_clean(v) for v in obj]
    return obj


def _online_keys(os: OnlineSummary) -> Dict[str, Any]:
    """The metrics-derived summary entries (the JAX package's keys)."""
    n = max(int(os.n_ticks), 1)
    return {
        "mean_util_variance": float(os.sum_util_var) / n,
        "mean_util": float(os.sum_mean_util) / n,
        "mean_flow_rate": float(os.sum_flow_rate) / n,
        "util_time_variance": float(os.w_m2_util) / n,
        "total_arrivals": int(os.sum_arrivals),
        "total_decisions": int(os.sum_decisions),
        "total_migration_starts": int(os.sum_migrations),
        "flow_ticks": int(os.sum_active_flows),
        "peak_running": int(os.peak_running),
        "peak_deployed": int(os.peak_deployed),
        "peak_overloaded": int(os.peak_overloaded),
        "peak_queue": int(os.peak_inactive),
        "soft_expected_comm": (float(os.sum_soft_comm)
                               / max(float(os.sum_soft_n), 1.0)),
        "soft_expected_util": (float(os.sum_soft_util)
                               / max(float(os.sum_soft_n), 1.0)),
        "soft_expected_mig_util": (float(os.sum_soft_mig)
                                   / max(float(os.sum_soft_mig_n), 1.0)),
        "soft_blend": (float(os.sum_soft_comm + os.sum_soft_util)
                       / max(float(os.sum_soft_n), 1.0)),
    }


def summarize(final: SimState,
              metrics: TickMetrics | OnlineSummary) -> Dict[str, Any]:
    """End-of-run summary from the final state plus the stacked per-tick
    series (or its ``OnlineSummary`` fold)."""
    ct = final.containers
    status = _np(ct.status)
    completed = status == STATUS_COMPLETED
    submit = _np(ct.submit_t)
    start = _np(ct.start_t)
    finish = _np(ct.finish_t)
    born = np.isfinite(submit)
    started = start >= 0

    resp = np.where(started & born, start - submit, np.nan)
    runtime = np.where(completed, finish - submit, np.nan)
    exec_time = np.where(completed, finish - start, np.nan)

    def nanmean(x):
        x = x[np.isfinite(x)]
        return float(x.mean()) if x.size else float("nan")

    comm_time = _np(ct.comm_time)[born]
    rep = {
        "n_containers": int(born.sum()),
        "n_completed": int(completed.sum()),
        "completion_rate": float(completed.sum() / max(born.sum(), 1)),
        "avg_response_time": nanmean(resp),
        "avg_runtime": nanmean(runtime),           # submit -> finish
        "avg_exec_time": nanmean(exec_time),       # deploy -> finish
        "avg_comm_time": float(comm_time.mean()) if comm_time.size
        else float("nan"),
        "total_cost": float(final.total_cost),
        "total_migrations": int(_np(ct.n_migrations).sum()),
        "final_t": float(final.t),
    }
    if not isinstance(metrics, OnlineSummary):
        metrics = online_from_metrics(metrics)
    rep.update(_online_keys(metrics))
    return rep


def timeseries(metrics: TickMetrics) -> Dict[str, np.ndarray]:
    """Stacked per-tick series as a plain dict of numpy arrays."""
    return {k: _np(v) for k, v in metrics._asdict().items()}


def to_csv(metrics: TickMetrics, path: str) -> None:
    ts = timeseries(metrics)
    keys = list(ts.keys())
    rows = np.stack([ts[k].astype(np.float64) for k in keys], axis=1)
    np.savetxt(path, rows, delimiter=",", header=",".join(keys), comments="")
