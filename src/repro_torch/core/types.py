"""Struct-of-arrays state for the PyTorch port of the DCSim engine.

The counterpart of ``repro.core.types``: the same NamedTuples with the same
field names, holding ``torch.Tensor`` leaves on one explicit device.  The
six container states of paper Table 2 map to ``STATUS_*`` codes, and a
scheduling policy is a weight vector laid out by the ``W_*``/``F_*``/``M_*``
indices below (identical to the JAX package's layout, so a weight vector
means the same thing in both packages).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import KERNEL_FLAGS

# ---------------------------------------------------------------------------
# Container lifecycle (paper Table 2)
# ---------------------------------------------------------------------------
STATUS_UNBORN = -1        # slot exists but the job has not been submitted yet
STATUS_INACTIVE = 0       # submitted, not scheduled            (undeployed)
STATUS_RUNNING = 1        # deployed and executing              (deployed)
STATUS_COMMUNICATING = 2  # paused on a network transfer        (deployed)
STATUS_MIGRATING = 3      # being moved to another host         (dep+undep)
STATUS_WAITING = 4        # suspended after comm/migration fail (undeployed)
STATUS_COMPLETED = 5      # finished                            (completed)

# Container primary resource types (paper §3.3)
CTYPE_CPU = 0
CTYPE_MEM = 1
CTYPE_GPU = 2

NUM_RESOURCES = 3  # cpu (%), mem (GB), gpu (%)

F32 = torch.float32
I32 = torch.int32


class HostState(NamedTuple):
    """Heterogeneous hosts (paper Table 5): capacity, *speed* and price."""

    cap: torch.Tensor           # f32[H, 3]  resource capacity
    speed: torch.Tensor         # f32[H, 3]  per-resource processing speed
    price: torch.Tensor         # f32[H]     $ per busy second
    used: torch.Tensor          # f32[H, 3]  currently committed resources
    n_containers: torch.Tensor  # i32[H]     deployed container count
    leaf: torch.Tensor          # i32[H]     leaf switch this host hangs off
    busy_time: torch.Tensor     # f32[H]     seconds with >= 1 container


class ContainerState(NamedTuple):
    """Three-tier Job -> Task -> Container model, SoA over container slots."""

    status: torch.Tensor          # i32[C] STATUS_*
    ctype: torch.Tensor           # i32[C] CTYPE_* (primary resource)
    req: torch.Tensor             # f32[C, 3] resource request
    duration: torch.Tensor        # f32[C] total work units
    run_at: torch.Tensor          # f32[C] executed work units
    host: torch.Tensor            # i32[C] current host (-1 undeployed)
    job: torch.Tensor             # i32[C] job id
    task: torch.Tensor            # i32[C] task id
    submit_t: torch.Tensor        # f32[C] arrival time
    start_t: torch.Tensor         # f32[C] first deployment time (-1)
    finish_t: torch.Tensor        # f32[C] completion time (-1)
    n_comms_left: torch.Tensor    # i32[C] remaining communication events
    comm_work_gap: torch.Tensor   # f32[C] work units between comm triggers
    next_comm_at: torch.Tensor    # f32[C] work-unit threshold of next comm
    comm_bytes: torch.Tensor      # f32[C] KB per communication event
    comm_bytes_left: torch.Tensor  # f32[C] KB outstanding on the active comm
    comm_peer: torch.Tensor       # i32[C] partner of the active comm (-1)
    comm_time: torch.Tensor       # f32[C] accumulated communicating seconds
    retry: torch.Tensor           # i32[C] consecutive stalled ticks
    mig_dst: torch.Tensor         # i32[C] destination while migrating (-1)
    mig_bytes_left: torch.Tensor  # f32[C] KB outstanding on the migration
    n_migrations: torch.Tensor    # i32[C] completed migrations


class NetState(NamedTuple):
    """Spine-leaf network: static link tables + dynamic delay matrix."""

    link_bw: torch.Tensor       # f32[E] Mbps
    link_delay: torch.Tensor    # f32[E] ms base delay
    link_loss: torch.Tensor     # f32[E] packet loss fraction
    link_u: torch.Tensor        # i32[E] node ids of each link's ends
    link_v: torch.Tensor        # i32[E]
    path_links: torch.Tensor    # i32[H, H, 4] ECMP path links (-1 pad)
    path_nlinks: torch.Tensor   # i32[H, H]
    link_bw_kbps: torch.Tensor  # f32[E] link_bw in KB/s
    path_loss: torch.Tensor     # f32[H, H] end-to-end loss along the path
    link_util: torch.Tensor     # f32[E] utilization from last tick's flows
    delay_matrix: torch.Tensor  # f32[H, H] host-to-host delay (paper's D)
    comm_cost: torch.Tensor     # f32[H, H] expected cost of one comm unit


class PolicyParams(NamedTuple):
    """A scheduling policy IS its weight vector (``NUM_POLICY_WEIGHTS``)."""

    weights: torch.Tensor       # f32[NUM_POLICY_WEIGHTS]


# ---------------------------------------------------------------------------
# PolicyParams.weights layout — identical to repro.core.types.
# ---------------------------------------------------------------------------
W_UTIL = 0
W_CROSS_LEAF = 1
W_SEL_SUBMIT = 2
W_SEL_DURATION = 3
W_ROW0 = 4
F_RECENCY = 0
F_NEG_SPEED = 1
F_WORST_FIT = 2
F_COLOC = 3
F_COMM = 4
F_FALLBACK_WORST = 5
F_HOST_UTIL = 6
F_FREE_CPU = 7
F_FREE_MEM = 8
F_UPLINK_UTIL = 9
F_CROSS_LEAF = 10
NUM_ROW_FEATURES = 11
W_RR_TRACK = W_ROW0 + NUM_ROW_FEATURES
W_MIG_ENABLE = W_RR_TRACK + 1
W_MIG0 = W_MIG_ENABLE + 1
M_IDX = 0
M_PATH_UTIL = 1
M_CROSS_LEAF = 2
M_WORST_FIT = 3
NUM_MIG_FEATURES = 4
NUM_POLICY_WEIGHTS = W_MIG0 + NUM_MIG_FEATURES

WEIGHT_NAMES: tuple = (
    "util", "cross_leaf",
    "sel_submit", "sel_duration",
    "row_recency", "row_neg_speed", "row_worst_fit", "row_coloc",
    "row_comm", "row_fallback_worst", "row_host_util", "row_free_cpu",
    "row_free_mem", "row_uplink_util", "row_cross_leaf",
    "rr_track",
    "mig_enable", "mig_idx", "mig_path_util", "mig_cross_leaf",
    "mig_worst_fit",
)
if len(WEIGHT_NAMES) != NUM_POLICY_WEIGHTS:
    raise AssertionError("WEIGHT_NAMES must name every policy weight")


class RunParams(NamedTuple):
    """Runtime simulation parameters (0-d f32 tensors)."""

    bw_mbps: torch.Tensor             # <= 0 keeps the topology's bandwidth
    loss: torch.Tensor                # < 0 keeps the topology's loss
    queue_coef: torch.Tensor          # M/M/1 queueing-delay coefficient
    overload_threshold: torch.Tensor  # migration source / stats threshold
    idle_threshold: torch.Tensor      # migration destination threshold
    tau: torch.Tensor                 # soft-placement temperature (unread
    #                                   until soft placement is ported)


class SchedState(NamedTuple):
    """Scheduler bookkeeping (0-d i32 tensors)."""

    rr_pointer: torch.Tensor   # last host used by Round
    decisions: torch.Tensor    # placement decisions made this tick
    migrations: torch.Tensor   # migrations started this tick


class SimState(NamedTuple):
    """Whole simulator state.  The JAX package's ``rng`` leaf is left out:
    no tick phase reads it."""

    t: torch.Tensor            # f32[] simulation clock (seconds)
    hosts: HostState
    containers: ContainerState
    net: NetState
    sched: SchedState
    total_cost: torch.Tensor   # f32[] accumulated host-price cost


class TickMetrics(NamedTuple):
    """Per-tick observables (paper's data-collection module).  ``run_sim``
    stacks them along a trailing time axis.  The ``soft_*`` surrogate terms
    stay exact 0.0 until soft placement is ported; they are kept so that
    ``report.summarize`` gives the JAX package's keys."""

    t: torch.Tensor
    n_overloaded: torch.Tensor
    n_inactive: torch.Tensor
    n_running: torch.Tensor
    n_deployed: torch.Tensor
    n_communicating: torch.Tensor
    n_waiting: torch.Tensor
    n_completed: torch.Tensor
    n_migrating: torch.Tensor
    new_arrivals: torch.Tensor
    decisions: torch.Tensor
    migrations: torch.Tensor
    util_variance: torch.Tensor
    mean_util: torch.Tensor
    active_flows: torch.Tensor
    mean_flow_rate: torch.Tensor
    soft_comm: torch.Tensor
    soft_util: torch.Tensor
    soft_n: torch.Tensor
    soft_mig: torch.Tensor
    soft_mig_n: torch.Tensor


class SummaryAcc(NamedTuple):
    """Per-chunk summary accumulator of a streamed run (0-d tensors in the
    tick's f32/i32, on the run's device): every tick folds its metrics in
    (``stats.acc_update``) instead of being stacked.  Integer sums stay
    exact because ``stats.check_chunk`` bounds the ticks of a chunk; float
    sums carry a Kahan compensation term; ``stats.online_fold`` promotes a
    finished chunk to the host's f64/i64 ``OnlineSummary``."""

    n_ticks: torch.Tensor           # i32 ticks folded into this chunk
    sum_util_var: torch.Tensor      # f32 Kahan sum of util_variance
    c_util_var: torch.Tensor        # f32 its compensation term
    sum_mean_util: torch.Tensor     # f32
    c_mean_util: torch.Tensor       # f32
    sum_flow_rate: torch.Tensor     # f32
    c_flow_rate: torch.Tensor       # f32
    w_mean_util: torch.Tensor       # f32 Welford mean of mean_util
    w_m2_util: torch.Tensor         # f32 Welford M2 of mean_util
    sum_active_flows: torch.Tensor  # i32 flow-ticks
    sum_arrivals: torch.Tensor      # i32
    sum_decisions: torch.Tensor     # i32
    sum_migrations: torch.Tensor    # i32 migration starts
    peak_running: torch.Tensor      # i32
    peak_deployed: torch.Tensor     # i32
    peak_overloaded: torch.Tensor   # i32
    peak_inactive: torch.Tensor     # i32
    sum_soft_comm: torch.Tensor     # f32 (soft terms: 0.0 until the
    c_soft_comm: torch.Tensor       #      autodiff slice)
    sum_soft_util: torch.Tensor
    c_soft_util: torch.Tensor
    sum_soft_n: torch.Tensor
    c_soft_n: torch.Tensor
    sum_soft_mig: torch.Tensor
    c_soft_mig: torch.Tensor
    sum_soft_mig_n: torch.Tensor
    c_soft_mig_n: torch.Tensor


class OnlineSummary(NamedTuple):
    """Host-side (numpy, f64/i64) summary of a run's metrics series —
    the shape ``report.summarize`` reads: folded chunk by chunk from
    ``SummaryAcc`` (``stats.online_fold``) or computed from a stacked
    series (``stats.online_from_metrics``).  Leaves broadcast over leading
    batch axes ([P, S, N] for a streamed sweep)."""

    n_ticks: np.ndarray
    sum_util_var: np.ndarray
    sum_mean_util: np.ndarray
    sum_flow_rate: np.ndarray
    w_mean_util: np.ndarray
    w_m2_util: np.ndarray
    sum_active_flows: np.ndarray
    sum_arrivals: np.ndarray
    sum_decisions: np.ndarray
    sum_migrations: np.ndarray
    peak_running: np.ndarray
    peak_deployed: np.ndarray
    peak_overloaded: np.ndarray
    peak_inactive: np.ndarray
    sum_soft_comm: np.ndarray
    sum_soft_util: np.ndarray
    sum_soft_n: np.ndarray
    sum_soft_mig: np.ndarray
    sum_soft_mig_n: np.ndarray


def check_devices(devices) -> None:
    """The port runs on one device: ``devices`` may be ``None`` or ``1``."""
    if devices not in (None, 1):
        raise NotImplementedError(
            f"devices={devices!r} is not ported yet: the port runs on one "
            f"device; several come with the multi-process fabric slice of "
            f"repro_torch")


# ExecPlan fields of the JAX package that later slices of the port bring:
# field -> (its default, the slice that ports it).
_LATER_PLAN_FIELDS = {
    "telescope": (False, "telescoping"),
    "procs": (1, "multi-process fabric"),
    "devices_per_proc": (1, "multi-process fabric"),
}


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """Execution knobs of a run — how it is executed, never what it
    simulates (``repro.core.types.ExecPlan``'s fields).

    Honoured: the kernel selectors, ``chunk`` (stream the horizon with
    online summaries) and ``slab`` (sweep cells gathered to the host
    together).  ``overlap`` is accepted and changes nothing: the port
    copies each slab synchronously.  ``devices`` may be ``None`` or ``1``:
    the port runs on one device.  ``telescope``, ``procs`` and
    ``devices_per_proc`` raise ``NotImplementedError`` when set to
    anything but their defaults, naming the slice that brings them."""

    chunk: int | None = None             # ticks per streamed chunk; None =
    #                                      stacked per-tick metrics
    slab: int | None = None              # sweep cells per host gather;
    #                                      None = the whole grid
    delay_kernel: str | None = None      # override SimConfig.delay_kernel
    waterfill_kernel: str | None = None  # override SimConfig.waterfill_kernel
    devices: int | None = None           # None or 1
    overlap: bool = True                 # the JAX field; no effect here
    telescope: bool = False
    procs: int = 1
    devices_per_proc: int = 1

    def __post_init__(self):
        for name in ("chunk", "slab"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"ExecPlan.{name} must be positive, "
                                 f"got {v}")
        if self.procs < 1 or self.devices_per_proc < 1:
            raise ValueError("ExecPlan.procs and devices_per_proc must be "
                             ">= 1")
        check_devices(self.devices)
        for name, (default, slice_name) in _LATER_PLAN_FIELDS.items():
            value = getattr(self, name)
            if value != default:
                raise NotImplementedError(
                    f"ExecPlan.{name}={value!r} is not ported yet: it comes "
                    f"with the {slice_name} slice of repro_torch")
        for name in ("delay_kernel", "waterfill_kernel"):
            v = getattr(self, name)
            if v is not None and v not in KERNEL_FLAGS:
                raise ValueError(f"ExecPlan.{name} must be one of "
                                 f"{KERNEL_FLAGS} or None, got {v!r}")

    def apply_to_config(self, cfg):
        """Fold the kernel selectors into the ``SimConfig``."""
        updates = {k: v for k, v in (("delay_kernel", self.delay_kernel),
                                     ("waterfill_kernel",
                                      self.waterfill_kernel))
                   if v is not None}
        return dataclasses.replace(cfg, **updates) if updates else cfg

    @classmethod
    def from_args(cls, args) -> "ExecPlan":
        """Build a plan from an ``argparse`` namespace of
        ``launch.execargs.add_exec_args``; missing attributes take the
        field defaults, and later-slice flags raise as the constructor
        does."""
        defaults = cls()

        def get(name, fallback):
            v = getattr(args, name, None)
            return fallback if v is None else v

        return cls(
            chunk=getattr(args, "chunk", None),
            slab=getattr(args, "slab", None),
            delay_kernel=getattr(args, "delay_kernel", None),
            waterfill_kernel=getattr(args, "waterfill_kernel", None),
            devices=getattr(args, "devices", None),
            overlap=not getattr(args, "no_overlap", False),
            telescope=bool(getattr(args, "telescope", False)),
            procs=get("procs", defaults.procs),
            devices_per_proc=get("devices_per_proc",
                                 defaults.devices_per_proc),
        )


def resolve_device(device=None) -> torch.device:
    """The device a constructor builds on: ``cuda`` unless the caller names
    another.  Asking for CUDA where there is none raises — the port never
    carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def device_name(device) -> str:
    """The name a report row records for ``device``."""
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over same-structure trees of (nested)
    NamedTuples."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    return fn(tree, *rest)


def take(x: torch.Tensor, i: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``x`` at the index held in the 0-d tensor ``i`` along ``dim``.
    Indexing with a 0-d tensor (``x[i]``) reads ``i`` back to the host — a
    device sync on CUDA; a one-element gather does not."""
    return x.index_select(dim, i.reshape(1).long()).squeeze(dim)


def empty_containers(capacity: int, device=None) -> ContainerState:
    device = resolve_device(device)
    C = capacity
    f = lambda fill: torch.full((C,), fill, dtype=F32, device=device)
    i = lambda fill: torch.full((C,), fill, dtype=I32, device=device)
    return ContainerState(
        status=i(STATUS_UNBORN), ctype=i(0),
        req=torch.zeros((C, NUM_RESOURCES), dtype=F32, device=device),
        duration=f(0.0), run_at=f(0.0), host=i(-1), job=i(-1), task=i(-1),
        submit_t=f(float("inf")), start_t=f(-1.0), finish_t=f(-1.0),
        n_comms_left=i(0), comm_work_gap=f(float("inf")),
        next_comm_at=f(float("inf")), comm_bytes=f(0.0),
        comm_bytes_left=f(0.0), comm_peer=i(-1), comm_time=f(0.0),
        retry=i(0), mig_dst=i(-1), mig_bytes_left=f(0.0), n_migrations=i(0),
    )


def make_hosts(cap: np.ndarray, speed: np.ndarray, price: np.ndarray,
               leaf: np.ndarray, device=None) -> HostState:
    device = resolve_device(device)
    H = cap.shape[0]
    as_t = lambda x, dt: torch.as_tensor(np.asarray(x), dtype=dt,
                                         device=device)
    return HostState(
        cap=as_t(cap, F32), speed=as_t(speed, F32), price=as_t(price, F32),
        used=torch.zeros((H, NUM_RESOURCES), dtype=F32, device=device),
        n_containers=torch.zeros((H,), dtype=I32, device=device),
        leaf=as_t(leaf, I32),
        busy_time=torch.zeros((H,), dtype=F32, device=device),
    )
