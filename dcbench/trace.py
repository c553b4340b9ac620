"""The traced window: ``torch.profiler`` over one unit, reduced to what
the per-layer readers read.

On the card the profiler records CUDA activity only (the runtime's
launch calls and the device's kernels, copies and sets): the host's
per-op events would multiply the trace several times over and its
reading by minutes.  The host spans are the port's own tick phases, the
labels ``engine.make_tick_ext`` opens with ``record_function``: inside
the traced window the engine's ``record_function`` is a recorder that
takes each label's host start and end on the wall clock the profiler
stamps its events with, and nothing else.  From these: the kernel
launch calls, each phase's host time, the device's ops by name, the
union of its busy intervals, and its idle gaps named by the phase the
host was in as each began.
"""
from __future__ import annotations

import bisect
import contextlib
import time

import torch
from torch.autograd import DeviceType

PHASES = ("phase_arrive", "phase_schedule", "phase_flows", "phase_progress",
          "delay_refresh", "stats_collect")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


class Trace:
    """One traced window's reduction (times in seconds, stamps in ns)."""

    def __init__(self, window_s: float):
        self.window_s = window_s
        self.launches = 0
        self.ranges = {p: [] for p in PHASES}     # name -> [(start, dur)]
        self.device_ops = {}                       # name -> [seconds, n]
        self.device = []                           # (start, end, name)
        self.busy_s = 0.0
        self.idle_by_phase = {}                    # phase -> seconds

    def range_seconds(self, name: str) -> float:
        return sum(d for _, d in self.ranges[name]) / 1e9

    def range_count(self, name: str) -> int:
        return len(self.ranges[name])

    def tick_spans_s(self) -> float:
        """Seconds inside full ticks: each from the start of its
        ``phase_arrive`` to the end of its ``stats_collect``."""
        starts = sorted(s for s, _ in self.ranges["phase_arrive"])
        ends = sorted(s + d for s, d in self.ranges["stats_collect"])
        return sum(e - s for s, e in zip(starts, ends)) / 1e9

    def device_union_s(self, match) -> float:
        """Seconds in which a device op whose name ``match`` accepts ran
        (the union of their intervals: kernels of one call that overlap,
        as programmatic dependent launches do, count once)."""
        return _union([(s, e) for s, e, n in self.device if match(n)])[0]

    def breakdown(self) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.idle_by_phase.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, (s, _) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _union(intervals):
    """(seconds covered, [(gap start, gap end)] between them)."""
    busy, cur_s, cur_e, gaps = 0, None, None, []
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e9, gaps


class Recorder:
    """Stands in for ``record_function`` in the engine's module while the
    window is traced: each label's host start and duration, in ns on
    the wall clock."""

    def __init__(self):
        self.spans = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t = time.time_ns()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append((t, time.time_ns() - t))


def reduce(events, spans: dict, window_s: float) -> Trace:
    tr = Trace(window_s)
    for name in PHASES:
        tr.ranges[name] = spans.get(name, [])
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            s = e.start_ns()
            d = e.duration_ns()
            op = tr.device_ops.setdefault(name, [0.0, 0])
            op[0] += d / 1e9
            op[1] += 1
            tr.device.append((s, s + d, name))
        elif name in LAUNCH_CALLS:
            tr.launches += 1
    tr.busy_s, gaps = _union([(s, e) for s, e, _ in tr.device])
    # name each idle gap by the phase the host was in as it began (the
    # phases follow one another and never nest)
    spans_sorted = sorted((s, s + d, n) for n, rs in tr.ranges.items()
                          for s, d in rs)
    starts = [s for s, _, _ in spans_sorted]
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        where = spans_sorted[i][2] if i >= 0 and spans_sorted[i][1] > g0 \
            else "between tick phases"
        tr.idle_by_phase[where] = tr.idle_by_phase.get(where, 0.0) \
            + (g1 - g0) / 1e9
    return tr


@contextlib.contextmanager
def traced(device: torch.device, engine, out: list):
    """Profile the body and append its :class:`Trace` to ``out``; the
    window is the body's host time between two synchronizes.  ``engine``
    is the port's engine module, whose ``record_function`` the
    :class:`Recorder` stands in for meanwhile."""
    from torch.profiler import ProfilerActivity, profile
    on_cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA] if on_cuda else [ProfilerActivity.CPU]
    sync = (lambda: torch.cuda.synchronize(device)) if on_cuda \
        else (lambda: None)
    rec, real = Recorder(), engine.record_function
    engine.record_function = rec
    try:
        with profile(activities=acts) as prof:
            sync()
            t0 = time.perf_counter()
            yield
            sync()
            window_s = time.perf_counter() - t0
    finally:
        engine.record_function = real
    events = prof.profiler.kineto_results.events()
    out.append(reduce(events, rec.spans, window_s))
