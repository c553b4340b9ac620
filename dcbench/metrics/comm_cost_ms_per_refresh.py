"""comm_cost_ms_per_refresh: host milliseconds of the port's
``comm_cost`` spans (the refresh's path-utilization gather and the comm
cost rebuilt from it) per refresh of the traced unit.  Network
(core/network.py ``update_delay_matrix``).  No value where the port
records no such span."""
from dcbench import port_trace


def read(rd):
    snap = port_trace.records(rd)
    spans = port_trace.named(snap, "comm_cost") if snap is not None else []
    if not spans:
        return None
    return sum(port_trace.dur_ns(s) for s in spans) / 1e6 / len(spans)
