"""admit_ms_per_candidate: host milliseconds of the port's
``admit_round`` spans less their ``host_sync`` child (the read-back of
the candidate count), over the candidates the rounds tried (counter
``candidates``): the host's dispatch a candidate.  Scheduling
(engine._place_batched)."""
from dcbench import port_trace


def read(rd):
    snap = port_trace.records(rd)
    if snap is None or not snap.totals.get("candidates"):
        return None
    ns, _ = port_trace.self_ns(snap, "admit_round")
    return ns / 1e6 / snap.totals["candidates"]
