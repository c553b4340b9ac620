"""delay_refresh_ms: host milliseconds of the ``delay_refresh`` range (the
delay matrix rebuilt over the congested fabric, core/network.py and the
fw_minplus kernel) per refresh in the traced unit."""


def read(rd):
    tr = rd.trace
    if tr is None or not tr.range_count("delay_refresh"):
        return None
    return tr.range_seconds("delay_refresh") * 1e3 \
        / tr.range_count("delay_refresh")
