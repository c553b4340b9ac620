"""flows_ms_per_tick: host milliseconds of the ``phase_flows`` range (the
flow allocation, core/network.py and the seg_waterfill kernel) per full
tick of the traced unit."""


def read(rd):
    tr = rd.trace
    if tr is None or not tr.range_count("phase_flows"):
        return None
    return tr.range_seconds("phase_flows") * 1e3 \
        / tr.range_count("phase_flows")
