"""sync_ms_per_tick: host milliseconds inside the port's ``host_sync``
spans (each a device read-back: the host waits there for the device's
queue to drain) over the ticks of the traced unit.  Tick driver
(core/engine.py)."""
from dcbench import port_trace


def read(rd):
    snap = port_trace.records(rd)
    if snap is None or not rd.traced["ticks"]:
        return None
    ns = sum(port_trace.dur_ns(s)
             for s in port_trace.named(snap, "host_sync"))
    return ns / 1e6 / rd.traced["ticks"]
