"""device_idle_share.sweep: 1 minus the union of the device's busy
intervals over the traced grid's window."""


def read(rd):
    tr = rd.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
