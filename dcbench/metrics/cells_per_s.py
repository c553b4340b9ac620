"""cells_per_s: sweep cells completed over the window's wall time, host
clock; the window holds whole grids only."""


def read(rd):
    return rd.counters["cells"] / rd.window_s
