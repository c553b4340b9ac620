"""The place_round_share reader on hand-built records (CPU, no card): the
kernel's launches over the admit rounds, and no value where the port has
no place_round (an older checkout), where the unit held no admit round,
or in an untraced run."""
from types import SimpleNamespace

import pytest

from dcbench.test_dcbench_port_trace import (
    TICK_TOTALS, TICKS, install, reader, records, trace_of)


@pytest.mark.parametrize("launches,want", [(2, 1.0), (1, 0.5), (0, 0.0)])
def test_share_of_the_rounds_that_took_the_kernel(monkeypatch, launches,
                                                  want):
    install(monkeypatch, records(TICKS, TICK_TOTALS))   # two admit rounds
    rd = SimpleNamespace(trace=trace_of(0.1, [(0, 1)]), traced={
        "ticks": 5, "calls": {"seg_waterfill": 2, "place_round": launches}})
    assert reader("place_round_share").read(rd) == pytest.approx(want)


@pytest.mark.parametrize("case", ["older_port", "no_round", "untraced"])
def test_no_value_where_there_is_nothing(monkeypatch, case):
    rows = [s for s in TICKS if case != "no_round" or s[0] == "tick"]
    install(monkeypatch, records(rows, TICK_TOTALS))
    calls = {"seg_waterfill": 2}
    if case != "older_port":
        calls["place_round"] = 0
    rd = SimpleNamespace(trace=trace_of(0.1, [(0, 1)]),
                         traced={"ticks": 5, "calls": calls})
    if case == "untraced":
        rd = SimpleNamespace(trace=None, traced=None)
    assert reader("place_round_share").read(rd) is None
