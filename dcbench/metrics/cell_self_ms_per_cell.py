"""cell_self_ms_per_cell: host milliseconds of the port's ``sweep_cell``
spans less their children (the cell's ``tick`` spans), over the cells:
taking the cell's views, the per-tick folds of its accumulator and the
chunk boundaries.  Sweep driver (launch/sweep.py make_stream_fn)."""
from dcbench import port_trace


def read(rd):
    snap = port_trace.records(rd)
    if snap is None:
        return None
    ns, cells = port_trace.self_ns(snap, "sweep_cell")
    return ns / 1e6 / cells if cells else None
