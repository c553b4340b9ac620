"""core_flow_share: the traced unit's active flow-ticks on six-link paths
(through the core of a fat tree; the port's device counter
``flows_6link``) over all its flow-ticks on links (``flows_<L>link``
summed over L).  Network (core/network.py's flow allocation).  No value
where nothing was counted: an untraced run, a port without the
counters, a fabric with no path past four links (the port counts only
there), a unit with no flow on a link."""
from dcbench import port_trace


def read(rd):
    snap = port_trace.records(rd)
    if snap is None:
        return None
    flows = {k: v for k, v in snap.totals.items()
             if k.startswith("flows_") and k.endswith("link")}
    total = sum(flows.values())
    return flows.get("flows_6link", 0) / total if total else None
