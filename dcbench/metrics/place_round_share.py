"""place_round_share: the traced unit's place_round launches (the kernel
wrapper's count, the harness's ``traced["calls"]``) over its
``admit_round`` spans: 1.0 where every admit round ran its candidate loop
as the one kernel, 0 where none did.  A checkout whose port has no
place_round reads nothing.  Scheduling (engine._place_batched,
kernels/place_round)."""
from dcbench import port_trace


def read(rd):
    snap = port_trace.records(rd)
    if snap is None or "place_round" not in rd.traced.get("calls", {}):
        return None
    rounds = len(port_trace.named(snap, "admit_round"))
    return rd.traced["calls"]["place_round"] / rounds if rounds else None
