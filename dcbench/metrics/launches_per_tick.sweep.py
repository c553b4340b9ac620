"""launches_per_tick.sweep: CUDA kernel launch calls over the ticks of the
traced grid (cells x horizon).  Tick driver (core/engine.py) as the
sweep drives it."""


def read(rd):
    tr = rd.trace
    if tr is None or not tr.device_ops or not rd.traced["ticks"]:
        return None
    return tr.launches / rd.traced["ticks"]
