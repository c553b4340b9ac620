"""device_idle_share: 1 minus the union of the device's busy intervals
(kernels, copies, sets) over the traced unit's window."""


def read(rd):
    tr = rd.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
