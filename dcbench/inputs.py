"""A cell's inputs, drawn in numpy from the seed.

The host fleet (paper Table 5's categories over the fleet, each host on
the first-hop switch its fabric gives) and the container workload
(paper Table 6, trace-shaped or bursty arrivals).  The draws follow the
port's own generators (``repro_torch.core.workload``, ``datacenter``)
draw for draw, so a seed gives the arrays those give;
``test_dcbench_reference.py`` holds them equal.  Both the program and
the plain reference are built from these arrays and nothing else.

A mix draws its containers once, from its own ``base_seed``, and a run's
seed orders them (:func:`ordered`): every seed gives the same set of
sizes, arrivals and jobs in another slot order, so the work of a run
does not swing with its seed, while ties between equal keys, which
break by slot, fall otherwise.
"""
from __future__ import annotations

import numpy as np

# paper Table 5: count, cpu cores, cpu speed, mem GB, mem speed, gpus,
# gpu speed, price a busy second
PAPER_HOST_CATEGORIES = (
    (5, 80, 1.0, 128, 1.0, 8, 1.0, 1.0),
    (5, 80, 2.0, 128, 2.0, 8, 2.0, 1.5),
    (5, 80, 3.0, 128, 3.0, 8, 3.0, 3.0),
    (5, 80, 4.0, 128, 4.0, 8, 4.0, 5.0),
)
HOST_CATEGORIES = {"paper-table5": PAPER_HOST_CATEGORIES}


def host_tables(leaf: np.ndarray, categories: str = "paper-table5") -> dict:
    """The fleet of ``len(leaf)`` hosts: each category ``n_hosts //
    len(categories)`` times, the remainder to the first, in category
    order; host ``h`` hangs off switch ``leaf[h]`` (a topology's
    ``host_switch``)."""
    n_hosts = len(leaf)
    cats = HOST_CATEGORIES[categories]
    per = max(1, n_hosts // len(cats))
    counts = [per] * len(cats)
    counts[0] += max(0, n_hosts - per * len(cats))
    cap, speed, price = [], [], []
    for n, (_, cores, cs, mem, ms, gpus, gs, p) in zip(counts, cats):
        for _ in range(n):
            cap.append([cores * 100.0, float(mem), gpus * 100.0])
            speed.append([cs, ms, gs])
            price.append(p)
    return dict(cap=np.asarray(cap, np.float32),
                speed=np.asarray(speed, np.float32),
                price=np.asarray(price, np.float32),
                leaf=np.asarray(leaf, np.int32))


def _assign_jobs_tasks(rng, n_jobs, n_tasks, n_containers):
    task_job = np.sort(rng.integers(0, n_jobs, size=n_tasks))
    task_job[:n_jobs] = np.arange(n_jobs)
    task_job = np.sort(task_job)
    cont_task = np.sort(rng.integers(0, n_tasks, size=n_containers))
    cont_task[:n_tasks] = np.arange(n_tasks)
    cont_task = np.sort(cont_task)
    return (task_job[cont_task].astype(np.int32),
            cont_task.astype(np.int32))


def _comm_gap(duration, n_comms):
    return np.where(duration > 0, duration / (n_comms + 1),
                    np.inf).astype(np.float32)


def _fill(rng, sim: dict, cont_job, cont_task, submit) -> dict:
    n = C = cont_job.shape[0]
    req = np.zeros((C, 3), np.float32)
    req[:, 0] = rng.uniform(*sim["cpu_req_range"], size=n)
    req[:, 1] = rng.uniform(*sim["mem_req_range"], size=n)
    req[:, 2] = rng.uniform(*sim["gpu_req_range"], size=n)
    norm = req / np.array([[1700.0, 32.0, 200.0]], np.float32)
    ctype = np.argmax(norm, axis=1).astype(np.int32)
    duration = rng.uniform(*sim["duration_range"], size=n).astype(np.float32)
    lo, hi = sim["n_comms_range"]
    n_comms = rng.integers(lo, hi + 1, size=n).astype(np.int32)
    comm_kb = rng.uniform(*sim["comm_kb_range"], size=n).astype(np.float32)
    gap = _comm_gap(duration, n_comms)
    return dict(req=req, ctype=ctype, duration=duration,
                n_comms_left=n_comms, comm_bytes=comm_kb, comm_work_gap=gap,
                next_comm_at=gap.copy(),
                submit_t=np.asarray(submit, np.float32),
                job=cont_job, task=cont_task)


def workload(sim: dict, arrival: str, seed: int) -> dict:
    """The container columns of one workload (every slot a real
    container): ``arrival`` is ``paper`` (jobs uniform over the arrival
    window), ``trace`` (exponential inter-arrival, lognormal durations of
    median 25 s clipped to 5-300 s) or ``bursty`` (four burst centres,
    1.5 s of Gaussian jitter)."""
    rng = np.random.default_rng(seed)
    cont_job, cont_task = _assign_jobs_tasks(
        rng, sim["n_jobs"], sim["n_tasks"], sim["n_containers"])
    window, n_jobs = sim["arrival_window"], sim["n_jobs"]
    if arrival == "paper":
        job_t = np.sort(rng.uniform(0.0, window, size=n_jobs))
        return _fill(rng, sim, cont_job, cont_task,
                     job_t.astype(np.float32)[cont_job])
    if arrival == "trace":
        job_t = np.cumsum(rng.exponential(window / max(n_jobs, 1),
                                          size=n_jobs)).astype(np.float32)
        cols = _fill(rng, sim, cont_job, cont_task, job_t[cont_job])
        dur = np.clip(rng.lognormal(np.log(25.0), 0.6,
                                    size=cont_job.shape[0]),
                      5.0, 300.0).astype(np.float32)
        gap = _comm_gap(dur, cols["n_comms_left"])
        cols.update(duration=dur, comm_work_gap=gap, next_comm_at=gap.copy())
        return cols
    if arrival == "bursty":
        centers = np.sort(rng.uniform(0.0, window, size=4))
        which = rng.integers(0, 4, size=n_jobs)
        jitter = rng.normal(0.0, 1.5, size=n_jobs)
        job_t = np.clip(centers[which] + jitter, 0.0,
                        None).astype(np.float32)
        return _fill(rng, sim, cont_job, cont_task, job_t[cont_job])
    raise KeyError(f"unknown arrival process {arrival!r}")


def ordered(cols: dict, seed: int) -> dict:
    """``cols`` with its container slots in the order a permutation drawn
    from ``seed`` gives (each container's row, its job and task ids and
    its arrival time with it)."""
    n = cols["job"].shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    return {k: np.ascontiguousarray(v[perm]) for k, v in cols.items()}


def mix_workload(sim: dict, traffic: dict, seed: int) -> dict:
    """A run's containers: the mix's draw from its ``base_seed`` in the
    order ``seed`` gives."""
    return ordered(workload(sim, traffic["arrival"], traffic["base_seed"]),
                   seed)
