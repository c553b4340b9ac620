"""The port's own spans and counters (``repro_torch.core.trace``) as the
per-layer readers read them.

The port records only while a profiler runs and starts its records anew
as one starts, so after a traced run they hold the traced unit: its
``tick`` spans, ``host_sync`` spans (one device read-back each, the site
its id), ``admit_round``, ``telescope_advance``, ``sweep_cell`` and
``slab_copy_fold`` spans, and the window's counters.
Span times are ``time.time_ns()``, the clock the profiler stamps the
device's events with.  A checkout whose port has no such module gives
no records, and the readers then give no value.
"""
from __future__ import annotations

import bisect

from dcbench import program


def tracer():
    """The port's tracing module, None in a checkout without one."""
    return getattr(program.port().engine, "trace", None)


def records(rd):
    """The port's snapshot ``(spans, totals)`` of the traced unit; None
    in an untraced run, where the port keeps no records, or where they
    hold no span."""
    if rd.trace is None:
        return None
    tr = tracer()
    if tr is None:
        return None
    snap = tr.snapshot()
    return snap if snap.spans else None


def dur_ns(s) -> int:
    return s.end_ns - s.start_ns


def named(snap, name: str) -> list:
    return [s for s in snap.spans if s.name == name]


def self_ns(snap, name: str) -> tuple:
    """(ns inside the spans ``name`` less their direct children, the
    number of such spans), as the port's own ``trace.self_ns`` reads it."""
    return tracer().self_ns(snap, name)


class Intervals:
    """Spans that do not overlap one another, for asking whether an
    instant falls inside one."""

    def __init__(self, spans):
        iv = sorted((s.start_ns, s.end_ns) for s in spans)
        self.starts = [a for a, _ in iv]
        self.ends = [b for _, b in iv]

    def __contains__(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t < self.ends[i]
