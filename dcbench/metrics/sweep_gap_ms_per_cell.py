"""sweep_gap_ms_per_cell: host milliseconds a cell of the traced grid spends
outside its ticks (each full tick from the start of its
``phase_arrive`` range to the end of its ``stats_collect``): building
and stacking the cells, the slab's copy to the host and its fold.
Sweep driver (launch/sweep.py)."""


def read(rd):
    tr = rd.trace
    cells = rd.traced["work"]
    if tr is None or not cells or not tr.range_count("phase_arrive"):
        return None
    return (tr.window_s - tr.tick_spans_s()) * 1e3 / cells
