"""syncs_per_tick: the port's device read-backs (its ``host_sync`` spans:
the admit count, the migration switch and steps, the telescoped event
test and horizon, the summary copy of a chunk) over the ticks of the
traced unit, cheap telescoped ticks counted.  Tick driver
(core/engine.py)."""
from dcbench import port_trace


def read(rd):
    snap = port_trace.records(rd)
    if snap is None or not rd.traced["ticks"]:
        return None
    return snap.totals.get("syncs", 0) / rd.traced["ticks"]
