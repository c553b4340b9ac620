"""The per-layer metric ``free_ms_per_tick`` (``metrics/free_ms_per_tick.py``):
host ms of the port's ``free_resources`` spans over the traced unit's
full ticks.  Its entry in BENCHMARK.json, its reader on hand-built
records, and a small traced run on the CPU through the harness, which
reads the spans the port records (CPU, no card)."""
import json
from types import SimpleNamespace

import pytest

from dcbench import program
from dcbench.test_dcbench_port_trace import (  # noqa: F401  (fixtures)
    BUSY, ROOT, install, no_module_check, reader, records, root, trace_of)

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = "free_ms_per_tick"
CELLS = ["sim100-burst", "sim100-telescoped", "fattree1k-backlog"]

# two full ticks, five releases each, and a telescoped advance that
# releases nothing
TICKS = [("tick", 0, -1, 0, 10)] \
    + [("free_resources", None, 0, 5 + 0.5 * i, 5.2 + 0.5 * i)
       for i in range(5)] \
    + [("tick", 1, -1, 10, 20)] \
    + [("free_resources", None, 6, 15 + 0.5 * i, 15.1 + 0.5 * i)
       for i in range(5)] \
    + [("telescope_advance", None, -1, 20, 24)]


def test_the_entry_is_a_tick_driver_metric_of_the_episode_cells():
    entries = [m for m in MAN["per_layer"] if m["name"] == NAME]
    assert entries == [{"name": NAME, "unit": "ms", "better": "lower",
                        "source": "program_span", "layer": "tick driver",
                        "moves": "ticks_per_s", "workloads": CELLS}]
    # appended after the per-layer entries that stood before it
    names = [m["name"] for m in MAN["per_layer"]]
    assert names.index(NAME) > names.index("comm_cost_ms_per_refresh")
    assert (ROOT / "dcbench" / "metrics" / f"{NAME}.py").is_file()


def test_the_reader_sums_the_spans_over_the_full_ticks(monkeypatch):
    install(monkeypatch, records(TICKS, {}))
    # five ticks of the unit, two of them full: the spans over the two
    rd = SimpleNamespace(trace=trace_of(0.03, BUSY),
                         traced={"ticks": 5, "work": 5})
    assert reader(NAME).read(rd) == pytest.approx((5 * 0.2 + 5 * 0.1) / 2)


@pytest.mark.parametrize("rows", [[], [("tick", 0, -1, 0, 10)],
                                  [("free_resources", None, -1, 0, 1)]])
def test_the_reader_gives_no_value_where_there_is_nothing(monkeypatch,
                                                          rows):
    rd = SimpleNamespace(trace=trace_of(0.1, BUSY),
                         traced={"ticks": 5, "work": 2})
    install(monkeypatch, records(rows, {}))
    assert reader(NAME).read(rd) is None
    # a port without the tracing module (an older checkout)
    monkeypatch.setattr(program.port(), "engine", SimpleNamespace())
    assert reader(NAME).read(rd) is None
    monkeypatch.undo()
    # an untraced run
    install(monkeypatch, records(TICKS, {}))
    assert reader(NAME).read(SimpleNamespace(trace=None, traced=None)) \
        is None


@pytest.mark.parametrize("cell", ["tiny-burst", "tiny-telescoped"])
def test_a_traced_run_reads_the_free_resources_spans(root, cell):
    from dcbench import harness
    out = harness.run_cell(cell, 2**31 + 33, 0.2, True, device="cpu",
                           root=root)
    assert out["correct"] is True
    got = out["metrics"][NAME]["value"]
    assert got > 0
    # the port's own records of the same traced unit: five releases a
    # full tick
    snap = program.port().engine.trace.snapshot()
    ticks = sum(s.name == "tick" for s in snap.spans)
    frees = [s for s in snap.spans if s.name == "free_resources"]
    assert ticks > 0 and len(frees) == 5 * ticks
    assert got == pytest.approx(
        sum(s.end_ns - s.start_ns for s in frees) / 1e6 / ticks)
