"""admitted_share: containers the admit rounds placed (device counter
``admitted``) over the candidates they tried (``candidates``); a
candidate with no feasible host is a wasted iteration.  Scheduling
(engine._place_batched)."""
from dcbench import port_trace


def read(rd):
    snap = port_trace.records(rd)
    if snap is None or not snap.totals.get("candidates"):
        return None
    return snap.totals.get("admitted", 0) / snap.totals["candidates"]
