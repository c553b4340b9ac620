"""Workload generation (paper §3.3): Job -> Task -> Container three-tier model.

Counterpart of ``repro.core.workload``.  The arrays are drawn on the host
with ``np.random.default_rng`` in the JAX package's draw order, so the same
``(cfg, seed)`` gives identical arrays in both packages; they are moved to
the requested device once.

* ``paper_workload`` — paper Table 6 synthetic distribution.
* ``bursty_workload`` — flash-crowd arrivals around a few burst centers.
* ``trace_workload`` — Alibaba GPU-trace-shaped generator (lognormal job
  sizes, exponential inter-arrival), same SoA output.

:func:`next_arrival_after` is the arrival component of the telescoping
engine's event horizon.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.datacenter import SimConfig
from repro_torch.core.types import (STATUS_UNBORN, ContainerState,
                                    empty_containers)


def next_arrival_after(containers: ContainerState,
                       t: torch.Tensor) -> torch.Tensor:
    """Earliest pending submit time strictly after tick ``t`` (an f32 0-d
    tensor on the containers' device, +inf when every slot has arrived):
    padded slots carry ``submit_t = inf`` and arrived ones have left
    STATUS_UNBORN, so the minimum over the unborn slots is the next
    ``phase_arrive`` event.  One masked reduction, no read-back."""
    pending = (containers.status == STATUS_UNBORN) & (containers.submit_t > t)
    return torch.where(pending, containers.submit_t, float("inf")).min()


def _assign_jobs_tasks(rng: np.random.Generator, n_jobs: int, n_tasks: int,
                       n_containers: int):
    """Split tasks over jobs and containers over tasks (>=1 each)."""
    task_job = np.sort(rng.integers(0, n_jobs, size=n_tasks))
    task_job[:n_jobs] = np.arange(n_jobs)
    task_job = np.sort(task_job)
    cont_task = np.sort(rng.integers(0, n_tasks, size=n_containers))
    cont_task[:n_tasks] = np.arange(n_tasks)
    cont_task = np.sort(cont_task)
    cont_job = task_job[cont_task]
    return cont_job.astype(np.int32), cont_task.astype(np.int32)


def _comm_schedule(duration: np.ndarray, n_comms: np.ndarray) -> np.ndarray:
    """Work-unit gap between communication trigger points; padded slots
    (duration 0) get inf = never trigger."""
    return np.where(duration > 0, duration / (n_comms + 1),
                    np.inf).astype(np.float32)


def _fill(C: int, rng: np.random.Generator, cfg: SimConfig,
          cont_job: np.ndarray, cont_task: np.ndarray,
          submit: np.ndarray) -> dict:
    """The generated columns as numpy arrays (draw order of the JAX
    package's ``_fill``)."""
    n = cont_job.shape[0]
    if n > C:
        raise ValueError(f"workload ({n}) exceeds container capacity ({C})")

    req = np.zeros((C, 3), np.float32)
    req[:n, 0] = rng.uniform(*cfg.cpu_req_range, size=n)
    req[:n, 1] = rng.uniform(*cfg.mem_req_range, size=n)
    req[:n, 2] = rng.uniform(*cfg.gpu_req_range, size=n)
    # primary resource type: dominant normalized request (paper §3.3 classes)
    norm = req[:n] / np.array([[1700.0, 32.0, 200.0]], np.float32)
    ctype = np.zeros(C, np.int32)
    ctype[:n] = np.argmax(norm, axis=1)

    duration = np.zeros(C, np.float32)
    duration[:n] = rng.uniform(*cfg.duration_range, size=n)
    n_comms = np.zeros(C, np.int32)
    n_comms[:n] = rng.integers(cfg.n_comms_range[0], cfg.n_comms_range[1] + 1,
                               size=n)
    comm_kb = np.zeros(C, np.float32)
    comm_kb[:n] = rng.uniform(*cfg.comm_kb_range, size=n)
    gap = _comm_schedule(duration, n_comms)

    submit_t = np.full(C, np.inf, np.float32)
    submit_t[:n] = submit
    job = np.full(C, -1, np.int32)
    task = np.full(C, -1, np.int32)
    job[:n] = cont_job
    task[:n] = cont_task
    return dict(req=req, ctype=ctype, duration=duration,
                n_comms_left=n_comms, comm_bytes=comm_kb, comm_work_gap=gap,
                next_comm_at=gap.copy(), submit_t=submit_t, job=job,
                task=task)


def _to_state(cols: dict, C: int, device) -> ContainerState:
    state = empty_containers(C, device=device)
    return state._replace(**{
        k: torch.as_tensor(v, device=state.status.device)
        for k, v in cols.items()})


def paper_workload(cfg: SimConfig, seed: int = 0,
                   capacity: int | None = None,
                   device=None) -> ContainerState:
    """Paper Table 6 distribution; jobs arrive uniformly in the window."""
    rng = np.random.default_rng(seed)
    C = capacity or cfg.n_containers
    cont_job, cont_task = _assign_jobs_tasks(
        rng, cfg.n_jobs, cfg.n_tasks, cfg.n_containers)
    job_arrival = np.sort(rng.uniform(0.0, cfg.arrival_window,
                                      size=cfg.n_jobs)).astype(np.float32)
    cols = _fill(C, rng, cfg, cont_job, cont_task, job_arrival[cont_job])
    return _to_state(cols, C, device)


def bursty_workload(cfg: SimConfig, seed: int = 0,
                    capacity: int | None = None, n_bursts: int = 4,
                    burst_width: float = 1.5,
                    device=None) -> ContainerState:
    """Flash-crowd arrivals: jobs cluster around ``n_bursts`` burst centers
    spread over the arrival window (Gaussian jitter of ``burst_width``
    s) — the overload-recovery axis of a scenario sweep."""
    rng = np.random.default_rng(seed)
    C = capacity or cfg.n_containers
    cont_job, cont_task = _assign_jobs_tasks(
        rng, cfg.n_jobs, cfg.n_tasks, cfg.n_containers)
    centers = np.sort(rng.uniform(0.0, cfg.arrival_window, size=n_bursts))
    which = rng.integers(0, n_bursts, size=cfg.n_jobs)
    jitter = rng.normal(0.0, burst_width, size=cfg.n_jobs)
    job_arrival = np.clip(centers[which] + jitter, 0.0,
                          None).astype(np.float32)
    cols = _fill(C, rng, cfg, cont_job, cont_task, job_arrival[cont_job])
    return _to_state(cols, C, device)


def trace_workload(cfg: SimConfig, seed: int = 0,
                   capacity: int | None = None,
                   device=None) -> ContainerState:
    """Alibaba-trace-shaped: lognormal job sizes, exponential inter-arrival."""
    rng = np.random.default_rng(seed)
    C = capacity or cfg.n_containers
    cont_job, cont_task = _assign_jobs_tasks(
        rng, cfg.n_jobs, cfg.n_tasks, cfg.n_containers)
    inter = rng.exponential(cfg.arrival_window / max(cfg.n_jobs, 1),
                            size=cfg.n_jobs)
    job_arrival = np.cumsum(inter).astype(np.float32)
    cols = _fill(C, rng, cfg, cont_job, cont_task, job_arrival[cont_job])
    # heavy-tailed durations typical of GPU training jobs; the comm schedule
    # is rebuilt through the same rule _fill used so padded slots stay inf
    n = cont_job.shape[0]
    dur = np.zeros(C, np.float32)
    dur[:n] = np.clip(rng.lognormal(np.log(25.0), 0.6, size=n), 5.0, 300.0)
    gap = _comm_schedule(dur, cols["n_comms_left"])
    cols.update(duration=dur, comm_work_gap=gap, next_comm_at=gap.copy())
    return _to_state(cols, C, device)
