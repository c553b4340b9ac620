"""The place_round_share reader on hand-built records (CPU, no card): the
kernel's launches over the admit rounds, and no value where the port has
no place_round (an older checkout), where the unit held no admit round,
or in an untraced run; and its per-layer entry."""
from types import SimpleNamespace

import pytest

from dcbench.test_dcbench_port_trace import (
    MAN, NEW, TICK_TOTALS, TICKS, install, reader, records, trace_of)


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


def test_the_entry_is_listed_after_the_port_readers_for_the_episode_cells():
    names = [m["name"] for m in MAN["per_layer"]]
    i = names.index("place_round_share")
    assert i > max(names.index(n) for n in NEW)      # appended after them
    assert MAN["per_layer"][i] == {
        "name": "place_round_share", "unit": "fraction", "better": "higher",
        "source": "program_counter", "layer": "scheduling",
        "moves": "ticks_per_s",
        "workloads": ["sim100-burst", "sim100-telescoped"]}
