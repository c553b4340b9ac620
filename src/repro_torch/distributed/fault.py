"""Fault tolerance: heartbeat failure detection, straggler deadlines, and
the recovery policy (``repro.distributed.fault``'s counterpart, pure
Python, its own copy).

The multi-process sweep fabric (``repro_torch.launch.dist``) feeds each
worker's slab request cadence to :class:`StragglerDetector`; the monitor,
the recovery plan and their state machine (suspect -> dead -> recover)
are the JAX package's, answer for answer.  ``TrainingSupervisor`` is the
training loop's checkpoint and restart glue (``launch/train.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

HEALTHY, SUSPECT, DEAD = "healthy", "suspect", "dead"


@dataclasses.dataclass
class FaultConfig:
    heartbeat_interval_s: float = 10.0
    suspect_after_s: float = 30.0      # missed heartbeats -> suspect
    dead_after_s: float = 120.0        # -> declared dead, trigger recovery
    straggler_factor: float = 2.0      # step slower than median x factor
    straggler_window: int = 20         # steps in the rolling median
    max_restarts: int = 100


class HeartbeatMonitor:
    """Tracks last-seen timestamps per worker; classifies liveness."""

    def __init__(self, workers: List[str], cfg: FaultConfig,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.clock = clock
        self.last_seen: Dict[str, float] = {w: clock() for w in workers}

    def beat(self, worker: str, t: Optional[float] = None) -> None:
        self.last_seen[worker] = self.clock() if t is None else t

    def status(self, worker: str) -> str:
        dt = self.clock() - self.last_seen[worker]
        if dt >= self.cfg.dead_after_s:
            return DEAD
        if dt >= self.cfg.suspect_after_s:
            return SUSPECT
        return HEALTHY

    def dead_workers(self) -> List[str]:
        return [w for w in self.last_seen if self.status(w) == DEAD]

    def all_healthy(self) -> bool:
        return all(self.status(w) == HEALTHY for w in self.last_seen)


class StragglerDetector:
    """Rolling-median step-time deadline; flags chronically slow workers
    (a flagged sweep worker is not waited on: it wins fewer slabs)."""

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self.history: Dict[str, List[float]] = {}

    def record(self, worker: str, step_time_s: float) -> None:
        h = self.history.setdefault(worker, [])
        h.append(step_time_s)
        if len(h) > self.cfg.straggler_window:
            h.pop(0)

    def median_step(self) -> float:
        all_t = sorted(t for h in self.history.values() for t in h)
        return all_t[len(all_t) // 2] if all_t else 0.0

    def stragglers(self) -> List[str]:
        med = self.median_step()
        if med <= 0:
            return []
        out = []
        for w, h in self.history.items():
            if len(h) >= 3:
                recent = sorted(h[-5:])[len(h[-5:]) // 2]
                if recent > med * self.cfg.straggler_factor:
                    out.append(w)
        return out


@dataclasses.dataclass
class RecoveryPlan:
    action: str                  # 'none' | 'restart' | 'elastic_downsize'
    reason: str = ""
    lost_workers: tuple = ()
    new_multi_pod: Optional[bool] = None


def plan_recovery(monitor: HeartbeatMonitor, n_pods: int,
                  workers_per_pod: int) -> RecoveryPlan:
    """Decide how to continue after failures (workers are named
    ``"<pod>:<index>"``):

    * all healthy              -> none
    * losses within spare set  -> restart from checkpoint on the same mesh
    * a whole pod unreachable  -> elastic downsize (restore the same
      checkpoint onto the single-pod mesh)
    """
    dead = monitor.dead_workers()
    if not dead:
        return RecoveryPlan("none")
    pods_hit = {w.split(":")[0] for w in dead}
    for pod in pods_hit:
        pod_dead = sum(1 for w in dead if w.startswith(pod + ":"))
        if pod_dead >= workers_per_pod:
            return RecoveryPlan(
                "elastic_downsize",
                reason=f"pod {pod} lost ({pod_dead}/{workers_per_pod})",
                lost_workers=tuple(dead), new_multi_pod=False)
    return RecoveryPlan("restart", reason=f"{len(dead)} workers dead",
                        lost_workers=tuple(dead))


class TrainingSupervisor:
    """Glue used by launch/train.py: step loop + checkpoint cadence +
    recovery hooks.  Deterministic data pipeline (per-step index seeding)
    makes post-restore replay exact."""

    def __init__(self, cfg: FaultConfig, ckpt_every: int,
                 save_fn: Callable[[int], None],
                 restore_fn: Callable[[], int]):
        self.cfg = cfg
        self.ckpt_every = ckpt_every
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.restarts = 0

    def maybe_checkpoint(self, step: int) -> bool:
        if step > 0 and step % self.ckpt_every == 0:
            self.save_fn(step)
            return True
        return False

    def recover(self) -> int:
        if self.restarts >= self.cfg.max_restarts:
            raise RuntimeError("restart budget exhausted")
        self.restarts += 1
        return self.restore_fn()
