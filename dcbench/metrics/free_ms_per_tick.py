"""free_ms_per_tick: host milliseconds of the port's ``free_resources``
spans (engine._free_resources: the requests and container counts a tick
releases on its hosts, five calls a full tick) over the full ticks of the
traced unit (its ``tick`` spans).  Tick driver (core/engine.py).  No
value where the port records no such span."""
from dcbench import port_trace


def read(rd):
    snap = port_trace.records(rd)
    if snap is None:
        return None
    spans = port_trace.named(snap, "free_resources")
    ticks = len(port_trace.named(snap, "tick"))
    if not spans or not ticks:
        return None
    return sum(port_trace.dur_ns(s) for s in spans) / 1e6 / ticks
