"""admit_idle_share: seconds of device idle gaps that began while the
host was inside the port's ``admit_round`` spans and outside their
``host_sync`` read-backs (the host dispatching the round), over the
traced window.  Gaps between the union of the device's busy intervals,
each named by the instant it began, as ``device_idle_share`` and the
phase breakdown take them; spans and device events on one clock.
Scheduling (engine._place_batched)."""
from dcbench import port_trace
from dcbench.trace import _union


def read(rd):
    snap = port_trace.records(rd)
    tr = rd.trace
    if snap is None or tr.busy_s <= 0:
        return None
    rounds = port_trace.Intervals(port_trace.named(snap, "admit_round"))
    syncs = port_trace.Intervals(port_trace.named(snap, "host_sync"))
    _, gaps = _union([(s, e) for s, e, _ in tr.device])
    idle = sum(g1 - g0 for g0, g1 in gaps
               if g0 in rounds and g0 not in syncs)
    return idle / 1e9 / tr.window_s
