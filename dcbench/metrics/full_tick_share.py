"""full_tick_share: full ticks over the ticks of the traced episode.  A
full tick is one pass through ``engine.make_tick_ext``'s phases (one
``phase_arrive`` span); the telescoped engine advances the others as
cheap ticks.  Tick driver, telescoped."""


def read(rd):
    tr = rd.trace
    if tr is None or not rd.traced["ticks"]:
        return None
    return tr.range_count("phase_arrive") / rd.traced["ticks"]
