"""slab_ms_per_cell: host milliseconds of the port's ``slab_copy_fold``
spans (a slab's finals and accumulators stacked, copied to the host in
one read-back and folded in f64) over the cells (``sweep_cell`` spans).
Sweep driver (launch/sweep.py make_stream_fn)."""
from dcbench import port_trace


def read(rd):
    snap = port_trace.records(rd)
    if snap is None:
        return None
    cells = len(port_trace.named(snap, "sweep_cell"))
    if not cells:
        return None
    ns = sum(port_trace.dur_ns(s)
             for s in port_trace.named(snap, "slab_copy_fold"))
    return ns / 1e6 / cells
