"""Multi-process sweep fabric: slab scheduling over worker processes with
a host-side reduction (``repro.launch.dist``'s counterpart).

The in-process sweep (``repro_torch.launch.sweep``) runs the policy x
scenario x seed grid cell after cell; this module spreads the SAME slab
runner over processes.  The design is the JAX package's,
*slab-per-process with a host-side reduction*:

* every worker builds the full grid from a JSON ``GridSpec`` (cheap and
  deterministic) on its own devices and integrates only the slabs it owns
  through ``make_stream_fn(...).iter_slabs``; nothing crosses processes
  inside the compute, so a straggler never stalls another worker;
* slab ownership is DYNAMIC: worker 0 runs a tiny TCP ``SlabServer``
  handing out start offsets on request, so fast workers take more slabs
  and a straggler (flagged by the rolling-median ``StragglerDetector`` of
  ``repro_torch.distributed.fault``) simply receives fewer; without a
  handout address the slabs are dealt round-robin;
* each finished slab is written ATOMICALLY (tmp dir + rename) as a small
  checkpoint through ``repro_torch.distributed.checkpoint``: the finals
  leaves and the slab's f64/i64 ``OnlineSummary``, so a crashed run
  RESUMES when rerun with the same ``out_dir`` (slabs on disk are skipped
  and merged);
* the reduction is ``stats.online_merge`` over per-worker partial
  summaries of disjoint cell support, exact over an ``n == 0`` partial
  (``nb/nb == 1.0`` in f64, sums add ``+0.0``, peaks max with ``0``), so
  the distributed result is BIT-IDENTICAL to the single-process sweep.

The grid spec, the slab plan, the slab checkpoints and the merge are the
JAX package's: a ``GridSpec`` JSON is key for key the JAX one, a slab
written by the JAX package merges here, and a slab written here merges
in the JAX package.  The JAX state carries one leaf the port's
``SimState`` does not have, its last, ``rng`` (the cell's
``jax.random.PRNGKey(seed)``, which no tick changes): a port slab writes
it under its JAX index, built in numpy from each cell's seed
(:func:`jax_rng_leaf`), and the port's merge does not read it.

A worker runs on ``device``'s type: worker ``i`` with ``d`` devices a
process takes the CUDA devices ``(i*d + j) % torch.cuda.device_count()``
for ``j < d`` (on one card every worker shares ``cuda:0``), or ``d``
times the CPU.  Each worker is a fresh interpreter
(``python -m repro_torch.launch.dist_worker``), never a fork, and joins a
``torch.distributed`` gloo group unless ``dist_init=False``; the compute
never depends on it.  Each worker writes its kernel launch counts into
its ``worker_XX.json``, which ``SweepResult.worker_meta`` surfaces.

    PYTHONPATH=src python -m repro_torch.launch.dist --policies all \\
        --seeds 2 --horizon 120 --procs 2 --devices-per-proc 2 --chunk 40
    PYTHONPATH=src python -m repro_torch.launch.dist --device cpu \\
        --procs 2 --devices-per-proc 2 --chunk 4 --horizon 10 --hosts 6

Worker mode (what the launcher spawns; on a fleet, one per host):

    python -m repro_torch.launch.dist_worker --spec grid_spec.json \\
        --out RUN --process-id 1 --num-processes 4 \\
        --coordinator host0:1234 --handout host0:1235
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import os
import pathlib
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import SimConfig, list_policies, stats
from repro_torch.core.report import json_clean
from repro_torch.core.scenario import (ScenarioSpec, build_scenarios,
                                       default_scenarios)
from repro_torch.core.scheduling import validate_weights
from repro_torch.core.types import (ExecPlan, OnlineSummary, PolicyParams,
                                    device_name, resolve_device)
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.fault import FaultConfig, StragglerDetector
from repro_torch.kernels import LAUNCHES, resolve_kernel
from repro_torch.launch.sweep import (SweepResult, _static_indices,
                                      make_stream_fn, stack_policies,
                                      tree_leaves_with_path, tree_unflatten)

_SRC = pathlib.Path(__file__).resolve().parents[2]   # .../src
_SLAB_RE = re.compile(r"slab_(\d{8})$")
_META_RE = re.compile(r"worker_(\d+)\.json$")


def _resolve_dist_plan(plan: ExecPlan | None, cfg: SimConfig,
                       fill_chunk: bool = True
                       ) -> tuple[ExecPlan, SimConfig]:
    """The fabric's plan and config, and its checks: no plan at all spawns
    the historical 2 workers (``ExecPlan.procs`` defaults to 1, which is
    right for the in-process entry points); ``telescope`` raises; a
    missing ``chunk`` becomes the largest bound-safe one with
    ``fill_chunk``, else raises; the kernel selectors fold into ``cfg``."""
    if plan is None:
        plan = ExecPlan(procs=2)
    if plan.telescope:
        # the GridSpec worker contract has no telescope field — passing
        # it through would silently run workers per-tick while the caller
        # believes they telescope
        raise ValueError(
            "telescope is not threaded through the multi-process fabric "
            "yet — drop procs (the in-process sweep telescopes) or drop "
            "telescope")
    cfg = plan.apply_to_config(cfg)
    if plan.chunk is None:
        if not fill_chunk:
            raise ValueError("the multi-process fabric requires chunk (it "
                             "streams slabs; there is no stacked "
                             "multi-process path)")
        plan = dataclasses.replace(plan, chunk=min(
            cfg.horizon, stats.max_chunk_ticks(cfg.n_containers)))
    return plan, cfg


def _slab_cells(B: int, slab: int | None, n_dev: int) -> int:
    """The slab plan: ``min(slab, B)`` padded to a device multiple.  Every
    worker MUST compute the same value or slab ownership diverges — the
    worker cross-checks its device count against the spec."""
    Bs = B if slab is None else min(slab, B)
    return Bs + (-Bs) % n_dev


def worker_devices(device, process_id: int,
                   devices_per_proc: int) -> tuple[torch.device, ...]:
    """Worker ``process_id``'s devices: ``devices_per_proc`` CUDA devices
    dealt round the visible ones, or the CPU that many times.  Asking for
    CUDA where there is none raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return (dev,) * devices_per_proc
    n = torch.cuda.device_count()
    return tuple(torch.device("cuda", (process_id * devices_per_proc + j) % n)
                 for j in range(devices_per_proc))


# ---------------------------------------------------------------------------
# GridSpec: the JSON contract between launcher and workers
# ---------------------------------------------------------------------------

_TUPLE_FIELDS = {f.name for f in dataclasses.fields(SimConfig)
                 if isinstance(f.default, tuple)}


@dataclasses.dataclass
class GridSpec:
    """Everything a worker needs to rebuild the grid bit for bit: the
    config, the scenario ladder, seeds, the policy batch (names OR a raw
    weight matrix — tune ships sampled weights), topology sizes and the
    streaming plan.  JSON-serializable, key for key the JAX package's;
    ``SimConfig`` tuple fields are restored from JSON lists on load."""

    config: dict
    scenarios: list
    seeds: list
    n_hosts: int
    n_spine: int
    n_leaf: int
    chunk: int
    slab: int | None
    overlap: bool
    devices_per_proc: int
    policies: list | None = None
    weights: list | None = None

    @classmethod
    def build(cls, *, cfg: SimConfig, scenarios: Sequence[ScenarioSpec],
              seeds: Sequence[int], policies: Sequence[str] | None = None,
              weights=None, n_hosts: int, n_spine: int, n_leaf: int,
              chunk: int, slab: int | None, overlap: bool,
              devices_per_proc: int) -> "GridSpec":
        if (policies is None) == (weights is None):
            raise ValueError("exactly one of policies/weights")
        return cls(
            config=dataclasses.asdict(cfg),
            scenarios=[dataclasses.asdict(s) for s in scenarios],
            seeds=[int(s) for s in seeds],
            n_hosts=int(n_hosts), n_spine=int(n_spine), n_leaf=int(n_leaf),
            chunk=int(chunk), slab=None if slab is None else int(slab),
            overlap=bool(overlap), devices_per_proc=int(devices_per_proc),
            policies=None if policies is None else [str(p) for p in policies],
            weights=None if weights is None
            else np.asarray(weights, np.float32).tolist())

    def sim_config(self) -> SimConfig:
        return SimConfig(**{
            k: tuple(v) if k in _TUPLE_FIELDS else v
            for k, v in self.config.items()})

    def scenario_specs(self) -> list[ScenarioSpec]:
        return [ScenarioSpec(**d) for d in self.scenarios]

    def policy_params(self, device=None) -> PolicyParams:
        """The [P] policy batch on ``device`` (default ``cuda``)."""
        if self.policies is not None:
            return stack_policies(self.policies, device=device)
        W = np.asarray(self.weights, np.float32)
        validate_weights(W, "dist grid spec weights: ")
        return PolicyParams(weights=torch.as_tensor(
            W, device=resolve_device(device)))

    def policy_names(self) -> list[str]:
        if self.policies is not None:
            return list(self.policies)
        return [f"w{i:03d}" for i in range(len(self.weights))]

    @property
    def n_cells(self) -> int:   # P * S * N, without building the grid
        P = len(self.policies if self.policies is not None else self.weights)
        return P * len(self.scenarios) * len(self.seeds)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "GridSpec":
        with open(path) as f:
            return cls(**json.load(f))


GridBundle = collections.namedtuple(
    "GridBundle", "cfg net_spec sims rps pol scenarios")


def build_grid(spec: GridSpec, device=None) -> GridBundle:
    """Spec -> stacked simulator inputs on ``device``.  Deterministic:
    every worker (and the merging launcher) rebuilds the identical
    grid."""
    cfg = spec.sim_config()
    scen = spec.scenario_specs()
    net_spec, sims, rps = build_scenarios(
        scen, cfg, n_hosts=spec.n_hosts, n_spine=spec.n_spine,
        n_leaf=spec.n_leaf, seeds=spec.seeds, device=device)
    return GridBundle(cfg, net_spec, sims, rps,
                      spec.policy_params(device=device), scen)


# ---------------------------------------------------------------------------
# Dynamic slab handout: worker 0's coordinator + the worker-side queue
# ---------------------------------------------------------------------------

class SlabServer(threading.Thread):
    """Worker 0's slab coordinator: a one-line-per-connection TCP queue.

    Protocol: a worker connects and sends ``NEXT <wid>\\n``; the reply is
    a start offset or ``DONE``.  The server measures each worker's
    request cadence (one slab period) and feeds it to the rolling-median
    ``StragglerDetector`` — a straggler is not stalled on, it just wins
    fewer slabs.  The thread exits once every worker has been told DONE
    (daemon: a crashed worker cannot wedge worker 0 past
    ``--server-timeout``)."""

    def __init__(self, addr: tuple[str, int], starts: Sequence[int],
                 n_workers: int, fault_cfg: FaultConfig | None = None):
        super().__init__(daemon=True, name="slab-server")
        self.sock = socket.create_server(addr)
        self.sock.settimeout(0.5)
        self.queue = collections.deque(int(s) for s in starts)
        self.n_workers = n_workers
        self.assigned: dict[int, list[int]] = {}
        self.done: set[int] = set()
        self.detector = StragglerDetector(fault_cfg or FaultConfig())
        self._last_req: dict[int, float] = {}
        self._lock = threading.Lock()

    def _serve_one(self) -> None:
        try:
            conn, _ = self.sock.accept()
        except socket.timeout:
            return
        with conn:
            try:
                parts = conn.recv(4096).decode().split()
                wid = int(parts[1]) if len(parts) >= 2 else -1
            except (ValueError, UnicodeDecodeError, OSError):
                return
            now = time.monotonic()
            with self._lock:
                if wid in self._last_req:
                    self.detector.record(f"proc{wid}",
                                         now - self._last_req[wid])
                self._last_req[wid] = now
                if self.queue:
                    s0 = self.queue.popleft()
                    self.assigned.setdefault(wid, []).append(s0)
                    reply = str(s0)
                else:
                    self.done.add(wid)
                    reply = "DONE"
            try:
                conn.sendall((reply + "\n").encode())
            except OSError:
                pass

    def run(self) -> None:
        while len(self.done) < self.n_workers:
            self._serve_one()
        self.sock.close()

    def report(self) -> dict:
        with self._lock:
            return {
                "handout": "dynamic",
                "assignments": {str(w): list(s)
                                for w, s in sorted(self.assigned.items())},
                "stragglers": self.detector.stragglers(),
                "median_slab_s": round(self.detector.median_step(), 4),
            }


def _request_next(addr: str, wid: int, retry_s: float = 60.0) -> int | None:
    """One handout round-trip; retries while the coordinator comes up."""
    host, port = addr.rsplit(":", 1)
    deadline = time.monotonic() + retry_s
    while True:
        try:
            with socket.create_connection((host, int(port)),
                                          timeout=10.0) as s:
                s.sendall(f"NEXT {wid}\n".encode())
                buf = b""
                while not buf.endswith(b"\n"):
                    got = s.recv(64)
                    if not got:
                        break
                    buf += got
            reply = buf.decode().strip()
            return None if reply == "DONE" else int(reply)
        except (OSError, ValueError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


def _handout_queue(addr: str, wid: int):
    """Lazy slab-start iterable driven by the coordinator, fed straight to
    ``fn.iter_slabs``."""
    while True:
        s0 = _request_next(addr, wid)
        if s0 is None:
            return
        yield s0


# ---------------------------------------------------------------------------
# Worker: integrate owned slabs, checkpoint each one atomically
# ---------------------------------------------------------------------------

def completed_slab_starts(out_dir: str) -> set[int]:
    """Start offsets with a complete slab checkpoint on disk (manifest +
    shard both present — the atomic rename means a dir either exists fully
    or not at all; stray ``.tmp*`` dirs from a crash are ignored)."""
    done = set()
    if not os.path.isdir(out_dir):
        return done
    for name in os.listdir(out_dir):
        m = _SLAB_RE.fullmatch(name)
        if not m:
            continue
        p = os.path.join(out_dir, name)
        if (os.path.exists(os.path.join(p, "manifest.json"))
                and os.path.exists(os.path.join(p, "shard_0.npz"))):
            done.add(int(m.group(1)))
    return done


def jax_rng_leaf(seeds: Sequence[int], s0: int, real: int) -> np.ndarray:
    """The JAX state's ``rng`` leaf of cells ``s0 .. s0 + real - 1`` (seed
    innermost in the [P, S, N] cell order): ``jax.random.PRNGKey(seed)``
    of the default threefry implementation with 32-bit seeds, u32[2] =
    [0, seed mod 2^32]."""
    cells = np.arange(s0, s0 + real)
    seed = np.asarray(seeds, np.int64)[cells % len(seeds)]
    return np.stack([np.zeros_like(seed), seed & 0xFFFFFFFF],
                    axis=1).astype(np.uint32)


def _write_slab(out_dir: str, s0: int, real: int, leaves, statics,
                slab_sum: OnlineSummary, seeds: Sequence[int]) -> None:
    final = os.path.join(out_dir, f"slab_{s0:08d}")
    tmp = final + f".tmp{os.getpid()}"
    finals = {f"leaf_{i:03d}": x[:real]
              for i, x in enumerate(leaves) if i not in statics}
    finals[f"leaf_{len(leaves):03d}"] = jax_rng_leaf(seeds, s0, real)
    state = {
        "finals": finals,
        "summary": {k: v[:real]
                    for k, v in zip(OnlineSummary._fields, slab_sum)},
    }
    ckpt.save_checkpoint(tmp, state, step=s0, process_index=0)
    shutil.rmtree(final, ignore_errors=True)   # stale dir from a dead run
    os.rename(tmp, final)


def _worker_loop(spec: GridSpec, out_dir: str, process_id: int, *,
                 devices: Sequence[torch.device], slab_starts=None,
                 handout: str | None = None,
                 spawned_at: float | None = None) -> dict:
    """The per-worker slab loop: build the grid on ``devices[0]``, drive
    ``iter_slabs`` over this worker's starts (a coordinator queue or an
    explicit list) with the cells cut over ``devices``, checkpoint each
    slab, write the worker meta (with the kernel launches this loop
    made)."""
    t_start, t_wall = time.monotonic(), time.time()
    devices = tuple(torch.device(d) for d in devices)
    g = build_grid(spec, devices[0])
    P = g.pol.weights.shape[0]
    S, N = g.sims.t.shape
    B = P * S * N
    fn = make_stream_fn(g.cfg, g.net_spec.n_hosts, g.net_spec.n_nodes,
                        g.cfg.horizon, chunk=spec.chunk, slab=spec.slab,
                        devices=devices, overlap=spec.overlap)
    Bs = fn.slab_cells(B)
    planned = _slab_cells(B, spec.slab, spec.devices_per_proc)
    if Bs != planned:
        raise RuntimeError(
            f"process {process_id}: {len(devices)} device(s) pad the slab "
            f"to {Bs} cells but the spec planned {planned} "
            f"(devices_per_proc={spec.devices_per_proc}); every process "
            "must pad identically or slab ownership diverges")
    statics = _static_indices(g.sims)
    starts = (iter(slab_starts) if slab_starts is not None
              else _handout_queue(handout, process_id))
    before = dict(LAUNCHES)
    startup = time.time() - (t_wall if spawned_at is None else spawned_at)
    owned, walls = [], []
    t_prev = time.monotonic()
    for s0, leaves, slab_sum in fn.iter_slabs(g.sims, g.pol, g.rps, starts):
        _write_slab(out_dir, s0, min(Bs, B - s0), leaves, statics, slab_sum,
                    spec.seeds)
        owned.append(int(s0))
        now = time.monotonic()
        walls.append(round(now - t_prev, 4))
        t_prev = now
    meta = {
        "process_index": int(process_id),
        "slabs": owned,
        "slab_walls_s": walls,
        "n_local_devices": len(devices),
        "backend": "torch-" + devices[0].type,
        "devices": [str(d) for d in devices],
        "device_names": [device_name(d) for d in devices],
        "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES},
        "kernels_active": {
            "seg_waterfill": resolve_kernel(g.cfg.waterfill_kernel,
                                            devices[0]),
            "fw_minplus": (g.cfg.delay_mode == "fw"
                           and resolve_kernel(g.cfg.delay_kernel,
                                              devices[0]))},
        "startup_s": round(startup, 3),
        "wall_s": round(time.monotonic() - t_start, 3),
    }
    path = os.path.join(out_dir, f"worker_{process_id:02d}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(meta, f, indent=1)
    os.replace(path + ".tmp", path)
    return meta


def run_worker_inline(spec: GridSpec, out_dir: str, process_id: int,
                      slab_starts: Sequence[int], device=None,
                      devices: Sequence | None = None) -> dict:
    """One virtual worker in-process — the hook for uneven-partition and
    resume runs without spawning (the loop a spawned worker runs, minus
    the process group and the TCP handout).  ``devices`` defaults to
    :func:`worker_devices` of ``device`` (default ``cuda``)."""
    os.makedirs(out_dir, exist_ok=True)
    if devices is None:
        devices = worker_devices(device, process_id, spec.devices_per_proc)
    return _worker_loop(spec, out_dir, process_id, devices=devices,
                        slab_starts=list(slab_starts))


# ---------------------------------------------------------------------------
# Merge: the reduction of per-worker partials
# ---------------------------------------------------------------------------

def merge_out_dir(spec: GridSpec, out_dir: str,
                  grid: GridBundle | None = None):
    """Reassemble ``(finals, summary, worker_metas)`` from the slab
    checkpoints in ``out_dir`` (finals as host numpy with [P, S, N]
    leading axes, as the streamed sweep returns them).

    Finals rows are disjoint slices — pure assembly.  Summaries reduce as
    a tree: one [B]-support partial per owner (each worker's slabs, plus a
    synthetic ``resumed`` owner for slabs left by a previous run), folded
    with ``stats.online_merge`` — associative, and exact over disjoint
    support, so the reduction order can never change the result.  Raises
    with the missing-slab list when coverage is incomplete (the resume
    path: rerun with the same ``out_dir``).  The grid (shapes, dtypes and
    the topology leaves) is rebuilt on the CPU unless given."""
    g = grid or build_grid(spec, "cpu")
    P = g.pol.weights.shape[0]
    S, N = g.sims.t.shape
    B = P * S * N
    Bs = _slab_cells(B, spec.slab, spec.devices_per_proc)
    expected = set(range(0, B, Bs))

    statics = _static_indices(g.sims)
    host = [x.cpu().numpy() for _, x in tree_leaves_with_path(g.sims)]

    metas = []
    for name in sorted(os.listdir(out_dir)):
        if _META_RE.fullmatch(name):
            with open(os.path.join(out_dir, name)) as f:
                metas.append(json.load(f))
    claimed: dict[int, int] = {}
    for m in metas:
        for s0 in m["slabs"]:
            if s0 in claimed:
                raise RuntimeError(
                    f"slab {s0} claimed by workers {claimed[s0]} and "
                    f"{m['process_index']} — handout protocol violation")
            claimed[s0] = m["process_index"]

    on_disk = completed_slab_starts(out_dir)
    extra = sorted(on_disk - expected)   # diagnose plan mismatch FIRST: a
    if extra:                            # foreign plan also looks 'missing'
        raise RuntimeError(
            f"out_dir holds slabs from a different grid/slab plan "
            f"(e.g. start {extra[:4]}; this grid: B={B}, slab={Bs}); "
            "use a fresh out_dir")
    missing = sorted(expected - on_disk)
    if missing:
        raise RuntimeError(
            f"distributed sweep incomplete: {len(missing)}/{len(expected)} "
            f"slabs missing (first: {missing[:4]}); rerun with the same "
            "out_dir to resume")

    groups: dict = {m["process_index"]: list(m["slabs"]) for m in metas}
    orphans = sorted(on_disk - set(claimed))
    if orphans:
        groups["resumed"] = orphans

    finals_flat = [host[i][0, 0] if i in statics
                   else np.empty((B,) + host[i].shape[2:], host[i].dtype)
                   for i in range(len(host))]
    partials = []
    for _, slabs in sorted(groups.items(), key=lambda kv: str(kv[0])):
        if not slabs:
            continue
        part = stats.online_init((B,))
        for s0 in slabs:
            real = min(Bs, B - s0)
            like = {
                "finals": {f"leaf_{i:03d}":
                           np.empty((real,) + host[i].shape[2:],
                                    host[i].dtype)
                           for i in range(len(host)) if i not in statics},
                "summary": dict(zip(OnlineSummary._fields,
                                    stats.online_init((real,)))),
            }
            state, step = ckpt.restore_checkpoint(
                os.path.join(out_dir, f"slab_{s0:08d}"), like)
            if step != s0:
                raise RuntimeError(
                    f"slab_{s0:08d} manifest says step {step}")
            for i in range(len(host)):
                if i not in statics:
                    finals_flat[i][s0:s0 + real] = \
                        state["finals"][f"leaf_{i:03d}"]
            for j, fname in enumerate(OnlineSummary._fields):
                part[j][s0:s0 + real] = state["summary"][fname]
        partials.append(part)

    summary = (functools.reduce(stats.online_merge, partials)
               if partials else stats.online_init((B,)))
    leaves = [np.broadcast_to(x, (P, S, N) + x.shape).copy()
              if i in statics
              else x.reshape((P, S, N) + x.shape[1:])
              for i, x in enumerate(finals_flat)]
    finals = tree_unflatten(g.sims, leaves)
    summary = OnlineSummary(*(x.reshape((P, S, N)) for x in summary))
    return finals, summary, metas


# ---------------------------------------------------------------------------
# Launcher: spawn N workers, join, merge
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _log_tail(out_dir: str, i: int, lines: int = 30) -> str:
    path = os.path.join(out_dir, f"worker_{i:02d}.log")
    try:
        with open(path, errors="replace") as f:
            tail = f.readlines()[-lines:]
        return f"--- {path} ---\n" + "".join(tail)
    except OSError:
        return f"--- {path}: unreadable ---"


def _spawn_and_wait(spec_path: str, out_dir: str, num_procs: int,
                    dist_init: bool, device: str, timeout_s: float) -> None:
    """Start ``num_procs`` fresh worker interpreters and wait for all of
    them; the first to fail kills the others and raises with its log."""
    coord = f"127.0.0.1:{_free_port()}" if dist_init else None
    handout = f"127.0.0.1:{_free_port()}"
    procs = []
    logs = []
    try:
        env = dict(os.environ)
        env["PYTHONPATH"] = (str(_SRC) + os.pathsep
                             + env.get("PYTHONPATH", ""))
        for i in range(num_procs):
            cmd = [sys.executable, "-m", "repro_torch.launch.dist_worker",
                   "--spec", spec_path, "--out", out_dir,
                   "--process-id", str(i),
                   "--num-processes", str(num_procs),
                   "--handout", handout, "--device", device,
                   "--spawned-at", repr(time.time())]
            cmd += ["--coordinator", coord] if dist_init \
                else ["--no-dist-init"]
            log = open(os.path.join(out_dir, f"worker_{i:02d}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while True:
            rcs = [p.poll() for p in procs]
            for i, rc in enumerate(rcs):
                if rc not in (None, 0):
                    for q in procs:
                        q.kill()
                    raise RuntimeError(
                        f"worker {i} exited with rc={rc}\n"
                        + _log_tail(out_dir, i))
            if all(rc == 0 for rc in rcs):
                return
            if time.monotonic() > deadline:
                for q in procs:
                    q.kill()
                raise TimeoutError(
                    f"distributed sweep timed out after {timeout_s}s\n"
                    + "\n".join(_log_tail(out_dir, i)
                                for i in range(num_procs)))
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()


DistRun = collections.namedtuple("DistRun", "finals summary metas wall_s")


def run_spec(spec: GridSpec, *, num_procs: int, out_dir: str | None = None,
             dist_init: bool = True, device=None,
             timeout_s: float = 900.0) -> DistRun:
    """Spawn ``num_procs`` workers over ``spec`` on ``device``'s type
    (default ``cuda``), join, merge.  With a persistent ``out_dir`` a
    rerun resumes (completed slabs are skipped by the coordinator and
    merged from disk); the default is a temp dir removed after the
    merge."""
    device = resolve_device(device).type
    tmp = None
    if out_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="dist_sweep_")
        out_dir = tmp.name
    try:
        os.makedirs(out_dir, exist_ok=True)
        spec_path = os.path.join(out_dir, "grid_spec.json")
        spec.save(spec_path)
        t0 = time.time()
        _spawn_and_wait(spec_path, out_dir, num_procs, dist_init, device,
                        timeout_s)
        finals, summary, metas = merge_out_dir(spec, out_dir)
        return DistRun(finals, summary, metas, round(time.time() - t0, 2))
    finally:
        if tmp is not None:
            tmp.cleanup()


def make_dist_fn(cfg: SimConfig, scenarios: Sequence[ScenarioSpec],
                 seeds: Sequence[int], *,
                 policies: Sequence[str] | None = None, weights=None,
                 n_hosts: int = 20, n_spine: int = 2, n_leaf: int = 4,
                 plan: ExecPlan | None = None, out_dir: str | None = None,
                 dist_init: bool = True, device=None,
                 timeout_s: float = 900.0):
    """Drop-in sweep callable (``fn(sims, pols, rps) -> (finals,
    summary)`` with ``fn.n_devices``, like ``make_stream_fn``) that runs
    the grid MULTI-PROCESS: ``plan.procs`` workers of
    ``plan.devices_per_proc`` devices each, on ``device``'s type.  The
    spec — not the passed trees — is the source of truth: workers rebuild
    the grid from it, so the call only checks that the caller's batch
    matches (``launch.tune`` rides this for ``--procs``).  ``fn.last_run``
    is the last call's ``DistRun``, its worker metas included."""
    plan, cfg = _resolve_dist_plan(plan, cfg, fill_chunk=False)
    spec = GridSpec.build(cfg=cfg, scenarios=scenarios, seeds=seeds,
                          policies=policies, weights=weights,
                          n_hosts=n_hosts, n_spine=n_spine, n_leaf=n_leaf,
                          chunk=plan.chunk, slab=plan.slab,
                          overlap=plan.overlap,
                          devices_per_proc=plan.devices_per_proc)

    def fn(sims, pols, rps):
        P = len(spec.policy_names())
        S, N = len(spec.scenarios), len(spec.seeds)
        if pols.weights.shape[0] != P or tuple(sims.t.shape) != (S, N):
            raise ValueError(
                f"grid mismatch: spec is [{P},{S},{N}] but got "
                f"P={pols.weights.shape[0]}, (S,N)={tuple(sims.t.shape)}")
        if not torch.equal(pols.weights.detach().cpu(),
                           spec.policy_params("cpu").weights):
            raise ValueError("policy weights differ from the dist spec — "
                             "workers rebuild the grid from the spec")
        run = run_spec(spec, num_procs=plan.procs, out_dir=out_dir,
                       dist_init=dist_init, device=device,
                       timeout_s=timeout_s)
        fn.last_run = run
        return run.finals, run.summary

    fn.n_devices = plan.procs * plan.devices_per_proc
    fn.spec = spec
    fn.last_run = None
    return fn


def run_dist_sweep(policies: Sequence[str] | None = None,
                   scenarios: Sequence[ScenarioSpec] | None = None,
                   seeds: Sequence[int] = (0,),
                   cfg: SimConfig | None = None, n_hosts: int = 20,
                   n_spine: int = 2, n_leaf: int = 4,
                   plan: ExecPlan | None = None, out_dir: str | None = None,
                   dist_init: bool = True, device=None,
                   timeout_s: float = 900.0) -> SweepResult:
    """The multi-process twin of ``sweep.run_sweep``, always streamed (a
    missing ``plan.chunk`` defaults to the largest bound-safe chunk); no
    plan at all spawns 2 workers.  Returns the same ``SweepResult``, with
    ``worker_meta`` carrying each worker's slabs, walls, devices and
    kernel launches."""
    policies = list(policies if policies is not None else list_policies())
    scenarios = list(scenarios if scenarios is not None
                     else default_scenarios())
    plan, cfg = _resolve_dist_plan(plan, cfg or SimConfig())
    spec = GridSpec.build(cfg=cfg, scenarios=scenarios, seeds=seeds,
                          policies=policies, n_hosts=n_hosts,
                          n_spine=n_spine, n_leaf=n_leaf, chunk=plan.chunk,
                          slab=plan.slab, overlap=plan.overlap,
                          devices_per_proc=plan.devices_per_proc)
    run = run_spec(spec, num_procs=plan.procs, out_dir=out_dir,
                   dist_init=dist_init, device=device, timeout_s=timeout_s)
    return SweepResult(
        policies=policies, scenarios=scenarios, seeds=tuple(seeds),
        finals=run.finals, metrics=None, summary=run.summary,
        wall_s=run.wall_s, n_devices=plan.procs * plan.devices_per_proc,
        worker_meta=run.metas)


# ---------------------------------------------------------------------------
# CLI: launcher mode + worker mode
# ---------------------------------------------------------------------------

def worker_run(a) -> None:
    """The worker body, entered through ``repro_torch.launch.dist_worker``
    after the process group is up (or without one)."""
    spec = GridSpec.load(a.spec)
    os.makedirs(a.out, exist_ok=True)
    B = spec.n_cells
    Bs = _slab_cells(B, spec.slab, spec.devices_per_proc)
    all_starts = list(range(0, B, Bs))
    devices = worker_devices(a.device, a.process_id, spec.devices_per_proc)

    server = None
    if a.process_id == 0 and a.handout:
        # the coordinator comes up BEFORE the grid build, so other
        # workers' first requests never wait on worker 0's build (clients
        # also retry for 60 s while it boots)
        done = completed_slab_starts(a.out)
        host, port = a.handout.rsplit(":", 1)
        server = SlabServer((host, int(port)),
                            [s for s in all_starts if s not in done],
                            a.num_processes)
        server.start()

    if a.handout:
        meta = _worker_loop(spec, a.out, a.process_id, devices=devices,
                            handout=a.handout, spawned_at=a.spawned_at)
    else:
        done = completed_slab_starts(a.out)
        starts = [s for k, s in enumerate(all_starts)
                  if k % a.num_processes == a.process_id and s not in done]
        meta = _worker_loop(spec, a.out, a.process_id, devices=devices,
                            slab_starts=starts, spawned_at=a.spawned_at)

    if server is not None:
        server.join(timeout=a.server_timeout)
        path = os.path.join(a.out, "coordinator.json")
        with open(path + ".tmp", "w") as f:
            json.dump(server.report(), f, indent=1)
        os.replace(path + ".tmp", path)
    print(f"worker {a.process_id}: {len(meta['slabs'])} slab(s) on "
          f"{meta['devices']}, launches {meta['launches']}, start-up "
          f"{meta['startup_s']}s, {meta['wall_s']}s")


def _launcher_main(argv) -> None:
    ap = argparse.ArgumentParser(
        description="multi-process sweep: spawn N slab workers and merge")
    ap.add_argument("--policies", default="all")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--horizon", type=int, default=120)
    ap.add_argument("--hosts", type=int, default=20)
    ap.add_argument("--delay-mode", default="path", choices=["path", "fw"],
                    help="delay refresh: ECMP path sum or full APSP "
                         "(the fw_minplus kernel)")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=1,
                    help="devices each worker process takes")
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--slab", type=int, default=None)
    ap.add_argument("--no-overlap", action="store_true")
    ap.add_argument("--no-dist-init", action="store_true")
    ap.add_argument("--out-dir", default=None,
                    help="persistent run dir (enables resume)")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--table", default="avg_runtime")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device type the workers run on "
                         "(default cuda)")
    args = ap.parse_args(argv)

    policies = (list_policies() if args.policies == "all"
                else args.policies.split(","))
    cfg = SimConfig(horizon=args.horizon, delay_mode=args.delay_mode)
    n_leaf = max(4, args.hosts // 5)
    plan = ExecPlan(chunk=args.chunk, slab=args.slab,
                    overlap=not args.no_overlap, procs=args.procs,
                    devices_per_proc=args.devices_per_proc)
    res = run_dist_sweep(
        policies=policies, seeds=range(args.seeds), cfg=cfg,
        n_hosts=args.hosts, n_spine=max(2, n_leaf // 4), n_leaf=n_leaf,
        plan=plan, out_dir=args.out_dir, dist_init=not args.no_dist_init,
        device=args.device, timeout_s=args.timeout)
    cells = len(res.policies) * len(res.scenarios) * len(res.seeds)
    print(f"# {cells} cells over {args.procs} process(es) x "
          f"{args.devices_per_proc} device(s) in {res.wall_s}s")
    for m in res.worker_meta:
        print(f"# worker {m['process_index']}: slabs {m['slabs']} on "
              f"{m['devices']} ({m['device_names'][0]}), walls "
              f"{m['slab_walls_s']}, start-up {m['startup_s']}s, launches "
              f"{m['launches']}")
    print(res.table(args.table))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(json_clean(res.summaries()), f, indent=1)
        print(f"# wrote {args.out}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--worker" in argv:
        raise SystemExit(
            "worker mode lives in `python -m repro_torch.launch.dist_worker`"
            " — the process group comes up before this module runs")
    _launcher_main(argv)


if __name__ == "__main__":
    main()
