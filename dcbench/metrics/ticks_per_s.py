"""ticks_per_s: simulated seconds completed over the window's wall time
(every tick of the window, cheap telescoped ticks and those of a partial
episode included), host clock."""


def read(rd):
    return rd.counters["ticks"] / rd.window_s
