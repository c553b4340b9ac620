"""advance_ms_per_full_tick: host milliseconds of the port's
``telescope_advance`` spans (the quiescence test, the event horizon and
the cheap ticks after a full tick, engine._advance) over the full ticks
of the traced episode (its ``tick`` spans).  Tick driver, telescoped."""
from dcbench import port_trace


def read(rd):
    snap = port_trace.records(rd)
    if snap is None:
        return None
    adv = port_trace.named(snap, "telescope_advance")
    ticks = len(port_trace.named(snap, "tick"))
    if not adv or not ticks:
        return None
    return sum(port_trace.dur_ns(s) for s in adv) / 1e6 / ticks
