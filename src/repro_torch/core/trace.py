"""Spans and counters inside the port, recorded while a ``torch.profiler``
is active and at no other time.

The tick's phases are ``record_function`` labels (``engine.make_tick_ext``);
beneath them the port marks what a profiler's events cannot name: each
device read-back (a ``host_sync`` span, its site the span's id), the
admit round, the release of host resources (``free_resources``), the
telescoped advance and the sweep's cells, and counts where the work
happens (candidates tried, containers admitted).

    with trace.span("admit_round"):
        with trace.host_sync("admit_count"):
            n = int(valid.sum())
        trace.count("candidates", n)

* Recording follows ``torch.autograd._profiler_enabled()``, the switch
  ``record_function`` itself follows.  Off, :func:`span` and
  :func:`host_sync` return one shared no-op context and :func:`count`
  returns at once: no clock is read, nothing is allocated or recorded.
* The records are reset by the first call that finds a profiler running
  after a call or a :func:`snapshot` that found none, so after a
  profiled window they hold that window (between two profiled windows
  the port's ticks call in here, or the window's records are read).
* A span records its name, its id (a tick index, a cell index, a site),
  the index of its parent (the innermost span open as it opened, -1 for
  none) and its start and end by ``time.time_ns()``, the wall clock the
  profiler stamps its events with, so device idle gaps can be laid
  against the spans.
* A count is a host integer added to the window's totals.  A device
  count (:func:`count_device`) is a small integer tensor the port
  computes on the device only while recording, kept there and summed
  and read back once, when a snapshot is taken, which turns it into
  totals: no read-back inside a tick.
* :func:`self_ns` and :func:`syncs_by_site` read a snapshot, for the
  profiling tool (``launch/profile.py``) and the benchmark's readers.
"""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

_enabled = torch.autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    id: object            # tick index, cell index, read-back site or None
    parent: int           # index of the enclosing span, -1 for none
    start_ns: int
    end_ns: int           # -1 while the span is open


class Snapshot(NamedTuple):
    spans: list           # [Span], in the order they opened
    totals: dict          # counter -> int over the window


OFF = contextlib.nullcontext()     # the shared context of a span not recorded


class _Records:
    def __init__(self):
        self.on = False       # a profiler was running at the last call
        self.gen = 0          # bumped by every reset
        self.reset()

    def reset(self):
        self.spans = []       # [name, id, parent, start, end]
        self.stack = []       # indices of the open spans
        self.totals = {}
        self.device = {}      # (key, shape) -> [read, [tensors]]
        self.gen += 1


_REC = _Records()


def _active() -> bool:
    """Whether to record now; the first call that finds a profiler
    running after one that found none starts a new window."""
    if not _enabled():
        _REC.on = False
        return False
    if not _REC.on:
        _REC.on = True
        _REC.reset()
    return True


class _Span:
    __slots__ = ("row", "gen")

    def __init__(self, name: str, id):
        r = _REC
        self.gen = r.gen
        self.row = [name, id, r.stack[-1] if r.stack else -1, 0, -1]
        r.stack.append(len(r.spans))
        r.spans.append(self.row)

    def __enter__(self):
        self.row[3] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.row[4] = time.time_ns()
        if self.gen == _REC.gen:      # not a span of a window since reset
            _REC.stack.pop()
        return False


def span(name: str, id=None):
    """A context that records one span while a profiler runs."""
    if not _active():
        return OFF
    return _Span(name, id)


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to the window's counter ``name``."""
    if not _active():
        return
    _REC.totals[name] = _REC.totals.get(name, 0) + n


def count_device(key: str, make, read) -> None:
    """Add the integer device tensor ``make()`` to the window's device
    counter ``key`` (``make`` runs only while recording; nothing is read
    back).  A snapshot sums the window's tensors of one key and shape on
    the device, reads the sum back once as a list and adds ``read(list)``
    (counter name -> int) to its totals."""
    if not _active():
        return
    t = make()
    _REC.device.setdefault((key, tuple(t.shape)), [read, []])[1].append(t)


def host_sync(site: str):
    """A ``host_sync`` span around one device read-back at ``site``,
    counted as one of the window's ``syncs``."""
    if not _active():
        return OFF
    s = _Span("host_sync", site)
    count("syncs", 1)
    return s


def snapshot() -> Snapshot:
    """The window's spans and totals, its device counts read back."""
    _REC.on = _REC.on and _enabled()
    totals = dict(_REC.totals)
    for read, ts in _REC.device.values():
        if len(ts) > 1:
            ts[:] = [torch.stack(ts).sum(0)]
        for name, n in read(ts[0].tolist()).items():
            totals[name] = totals.get(name, 0) + n
    return Snapshot([Span(*row) for row in _REC.spans], totals)


def self_ns(snap: Snapshot, name: str) -> tuple:
    """(ns inside the spans ``name`` less what their direct children
    cover, the number of such spans).  Children of one span follow one
    another, so what they cover is the sum of their durations."""
    idx = {i for i, s in enumerate(snap.spans) if s.name == name}
    own = sum(snap.spans[i].end_ns - snap.spans[i].start_ns for i in idx)
    kids = sum(s.end_ns - s.start_ns for s in snap.spans if s.parent in idx)
    return own - kids, len(idx)


def syncs_by_site(snap: Snapshot) -> dict:
    """The window's ``host_sync`` spans counted by site."""
    out: dict = {}
    for s in snap.spans:
        if s.name == "host_sync":
            out[s.id] = out.get(s.id, 0) + 1
    return out
