"""launches_per_tick: CUDA kernel launch calls (the runtime's launch API
calls the profiler records) over the ticks of the traced unit: one
episode, its cheap telescoped ticks counted.  Tick driver
(core/engine.py)."""


def read(rd):
    tr = rd.trace
    if tr is None or not tr.device_ops or not rd.traced["ticks"]:
        return None
    return tr.launches / rd.traced["ticks"]
