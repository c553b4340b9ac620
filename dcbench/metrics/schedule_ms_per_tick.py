"""schedule_ms_per_tick: host milliseconds of the ``phase_schedule`` range
(the admit round and the migration round, core/scheduling.py through
engine._place_batched) per full tick of the traced unit."""


def read(rd):
    tr = rd.trace
    if tr is None or not tr.range_count("phase_schedule"):
        return None
    return tr.range_seconds("phase_schedule") * 1e3 \
        / tr.range_count("phase_schedule")
