"""Bridge: ML jobs -> DCSim containers (the PyTorch counterpart of the JAX
package's ``core/bridge.py``).

The paper's motivating workload is container-based distributed training
and inference.  A dry-run cell's roofline terms (a row of either
package's dry run: ``repro_torch.launch.dryrun`` writes the JAX keys) (per-device FLOPs, the
gradient exchange that crosses the fabric) become a DCSim job whose

* container compute demand  = per-device step FLOPs (scaled to the
  paper's work-unit clock, so heterogeneous host speeds matter), and
* pairwise communication    = the per-worker bytes exchanged per step,

so scheduling experiments ask the paper's own question ("where should
communication-heavy ML containers land?").  The body is numpy from the
seed, as there, so both packages build the same arrays; the result is a
``ContainerState`` on an explicit device.  Imported as
``repro_torch.core.bridge`` (``repro_torch.core`` does not export it).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.datacenter import SimConfig
from repro_torch.core.types import (ContainerState, empty_containers,
                                    resolve_device)
from repro_torch.core.h100 import PEAK_FLOPS


@dataclasses.dataclass(frozen=True)
class MLJobSpec:
    """One training/serving job derived from a dry-run cell."""
    arch: str
    shape: str
    n_workers: int             # containers (data-parallel workers)
    steps: int                 # training steps to simulate
    flops_per_step: float      # per worker
    coll_bytes_per_step: float  # per worker, to its ring neighbours
    mem_gb: float              # per-worker memory request


def job_from_dryrun(result: dict, n_workers: int = 8,
                    steps: int = 20) -> MLJobSpec:
    """Container compute = per-device step FLOPs from the dry-run row.

    Container *network* traffic = only the bytes that cross the data-center
    fabric between workers: the cross-pod gradient exchange (2 x active
    params in bf16 for a ring all-reduce); an arch without a registered
    config counts 1e9 active parameters."""
    mem_gb = max(1.0, min(32.0, result.get(
        "approx_bytes_per_device_gb", 4.0)))
    from repro_torch.configs import get_config
    try:
        n_active = get_config(result["arch"]).active_param_count()
    except KeyError:
        n_active = 1e9
    grad_exchange_bytes = 2.0 * 2.0 * n_active      # bf16, ring ~2x
    return MLJobSpec(
        arch=result["arch"], shape=result["shape"], n_workers=n_workers,
        steps=steps,
        flops_per_step=result["flops"],
        coll_bytes_per_step=grad_exchange_bytes,
        mem_gb=mem_gb)


def jobs_from_results(path: str, shape: str = "train_4k",
                      archs: Sequence[str] | None = None,
                      n_workers: int = 8, steps: int = 20):
    """The jobs of a dry-run results JSON: its rows with status ``ok``,
    this ``shape``, the ``single`` mesh and (if given) one of ``archs``."""
    with open(path) as f:
        rows = json.load(f)
    out = []
    for r in rows:
        if r.get("status") != "ok" or r["shape"] != shape:
            continue
        if r["mesh"] != "single":
            continue
        if archs and r["arch"] not in archs:
            continue
        out.append(job_from_dryrun(r, n_workers, steps))
    return out


def workload_from_jobs(jobs: Sequence[MLJobSpec], cfg: SimConfig,
                       capacity: int | None = None,
                       gpu_speed_flops: float = PEAK_FLOPS,
                       seed: int = 0, device=None) -> ContainerState:
    """Materialize MLJobSpecs as a DCSim ContainerState on ``device``.

    * duration (work units) = steps * flops / gpu_speed_flops (by default
      the H100's bf16 peak, ``core.h100.PEAK_FLOPS``; the JAX
      package's default is a TPU v5e's 197e12), clipped to [5, 300] — a
      speed-s host finishes in duration/s seconds, exactly the paper's
      model;
    * per-step collective traffic becomes ``n_comms = min(steps, 10)``
      comm events between same-job containers, carrying the job's bytes
      over its steps (in KB);
    * a GPU-heavy resource profile (ctype 2, the GPU-trace regime the
      paper targets with its Alibaba dataset); each job arrives at a
      uniform time in [0, 10) from ``seed``.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_total = sum(j.n_workers for j in jobs)
    C = capacity or n_total
    state = empty_containers(C, device=device)

    req = np.zeros((C, 3), np.float32)
    ctype = np.full(C, 2, np.int32)               # GPU-intensive
    duration = np.zeros(C, np.float32)
    n_comms = np.zeros(C, np.int32)
    comm_kb = np.zeros(C, np.float32)
    gap = np.full(C, np.inf, np.float32)
    first_at = np.full(C, np.inf, np.float32)
    submit = np.full(C, np.inf, np.float32)
    job_ids = np.full(C, -1, np.int32)
    task_ids = np.full(C, -1, np.int32)

    i = 0
    for jid, job in enumerate(jobs):
        arrive = rng.uniform(0.0, 10.0)
        dur = job.steps * job.flops_per_step / gpu_speed_flops
        dur = float(np.clip(dur, 5.0, 300.0))
        for _ in range(job.n_workers):
            req[i] = [400.0, job.mem_gb, 100.0]
            duration[i] = dur
            n_comms[i] = min(job.steps, 10)
            comm_kb[i] = job.coll_bytes_per_step / 1024.0 \
                * job.steps / n_comms[i]
            gap[i] = dur / (n_comms[i] + 1)
            first_at[i] = gap[i]
            submit[i] = arrive
            job_ids[i] = jid
            task_ids[i] = jid
            i += 1

    t = lambda a: torch.from_numpy(a).to(device)
    return state._replace(
        req=t(req), ctype=t(ctype), duration=t(duration),
        n_comms_left=t(n_comms), comm_bytes=t(comm_kb),
        comm_work_gap=t(gap), next_comm_at=t(first_at), submit_t=t(submit),
        job=t(job_ids), task=t(task_ids),
    )
