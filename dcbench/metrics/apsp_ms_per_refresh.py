"""apsp_ms_per_refresh: host milliseconds of the port's ``apsp`` spans
(the delay refresh's adjacency and all-pairs shortest paths through
fw_minplus, or the path sum in 'path' mode) per refresh of the traced
unit.  Network (core/network.py ``update_delay_matrix``).  No value
where the port records no such span."""
from dcbench import port_trace


def read(rd):
    snap = port_trace.records(rd)
    spans = port_trace.named(snap, "apsp") if snap is not None else []
    if not spans:
        return None
    return sum(port_trace.dur_ns(s) for s in spans) / 1e6 / len(spans)
