"""The per-layer readers of the port's own spans and counters
(``dcbench/port_trace.py``, ``repro_torch.core.trace``): each gives its
number on hand-built records and a hand-built trace and no number on
empty ones, and a small traced run on the CPU gives them from the port's
real records (CPU, no card)."""
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest

from dcbench import harness, program
from dcbench.trace import Trace, _union

ROOT = Path(harness.ROOT)
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
EPISODE = ["sim100-burst", "sim100-telescoped"]
# the per-layer entries that stood before these readers' (PR 26's)
FIRST = ("launches_per_tick", "full_tick_share", "schedule_ms_per_tick",
         "flows_ms_per_tick", "delay_refresh_ms", "fw_minplus_roofline",
         "seg_waterfill_roofline", "device_idle_share", "peak_mem_gib",
         "sweep_gap_ms_per_cell", "launches_per_tick.sweep",
         "device_idle_share.sweep")
NEW = {"syncs_per_tick": EPISODE, "sync_ms_per_tick": EPISODE,
       "admit_ms_per_candidate": EPISODE, "admitted_share": EPISODE,
       "admit_idle_share": EPISODE,
       "advance_ms_per_full_tick": ["sim100-telescoped"],
       "cell_self_ms_per_cell": ["sweep-paper-policies"],
       "slab_ms_per_cell": ["sweep-paper-policies"]}
MS = 1_000_000


def reader(name):
    return harness._module(ROOT / "dcbench" / "metrics" / f"{name}.py",
                           f"dcbench_metric_{name}")


def records(rows, totals):
    """A snapshot as the port gives it: rows of (name, id, parent, start
    ms, end ms)."""
    tr = program.port().engine.trace
    return tr.Snapshot([tr.Span(n, i, p, int(s * MS), int(e * MS))
                        for n, i, p, s, e in rows], dict(totals))


def install(monkeypatch, snap):
    real = program.port().engine.trace
    monkeypatch.setattr(program.port().engine, "trace",
                        SimpleNamespace(snapshot=lambda: snap,
                                        self_ns=real.self_ns))


def trace_of(window_s, busy_ms):
    tr = Trace(window_s)
    tr.device = [(int(s * MS), int(e * MS), "k") for s, e in busy_ms]
    tr.busy_s = _union([(s, e) for s, e, _ in tr.device])[0]
    return tr


# two full ticks, a telescoped advance after the second, five read-backs
TICKS = [("tick", 0, -1, 0, 10),
         ("admit_round", None, 0, 1, 5),
         ("host_sync", "admit_count", 1, 1, 2),
         ("host_sync", "mig_enabled", 0, 5, 5.5),
         ("tick", 1, -1, 10, 20),
         ("admit_round", None, 4, 11, 13),
         ("host_sync", "admit_count", 5, 11, 11.5),
         ("telescope_advance", None, -1, 20, 24),
         ("host_sync", "telescope_horizon", 7, 20, 21),
         ("host_sync", "telescope_event", 7, 22, 22.5)]
TICK_TOTALS = {"syncs": 5, "candidates": 8, "admitted": 6}
# device busy: a gap begun inside the first round's read-back (not
# counted), one begun inside the round past it (8 ms, counted), one begun
# inside the advance (not counted)
BUSY = [(0, 1.5), (3, 4), (12, 20), (25, 26)]
CELLS = [("sweep_cell", 0, -1, 0, 10),
         ("tick", 0, 0, 1, 4), ("tick", 1, 0, 5, 8),
         ("sweep_cell", 1, -1, 10, 20),
         ("tick", 0, 3, 11, 19),
         ("slab_copy_fold", None, -1, 20, 23),
         ("host_sync", "slab_copy", 5, 21, 22)]


@pytest.mark.parametrize("name,want", [
    ("syncs_per_tick", 5 / 5),
    ("sync_ms_per_tick", 3.5 / 5),
    ("admit_ms_per_candidate", (3 + 1.5) / 8),
    ("admitted_share", 6 / 8),
    ("admit_idle_share", 0.008 / 0.1),
    ("advance_ms_per_full_tick", 4 / 2)])
def test_tick_readers_on_hand_built_records(monkeypatch, name, want):
    install(monkeypatch, records(TICKS, TICK_TOTALS))
    rd = SimpleNamespace(trace=trace_of(0.1, BUSY),
                         traced={"ticks": 5, "work": 5})
    assert reader(name).read(rd) == pytest.approx(want)


def test_admit_idle_share_is_within_the_device_idle_share(monkeypatch):
    install(monkeypatch, records(TICKS, TICK_TOTALS))
    rd = SimpleNamespace(trace=trace_of(0.1, BUSY), traced={"ticks": 5})
    part = reader("admit_idle_share").read(rd)
    whole = reader("device_idle_share").read(rd)
    assert 0 < part <= whole
    # the same gap begun inside the read-back instead: not the round's
    rd.trace = trace_of(0.1, [(0, 1.2), (1.4, 1.5), (4.5, 20)])
    assert reader("admit_idle_share").read(rd) == 0.0


@pytest.mark.parametrize("name,want", [
    ("cell_self_ms_per_cell", ((10 - 6) + (10 - 8)) / 2),
    ("slab_ms_per_cell", 3 / 2)])
def test_sweep_readers_on_hand_built_records(monkeypatch, name, want):
    install(monkeypatch, records(CELLS, {"syncs": 1}))
    rd = SimpleNamespace(trace=trace_of(0.05, [(0, 1)]),
                         traced={"ticks": 3 * 120, "work": 2})
    assert reader(name).read(rd) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(NEW))
def test_readers_give_no_value_where_there_is_nothing(monkeypatch, name):
    rd = SimpleNamespace(trace=trace_of(0.1, BUSY),
                         traced={"ticks": 5, "work": 2})
    install(monkeypatch, records([], {}))
    assert reader(name).read(rd) is None
    # a port without the module (an older checkout): no value, no raise
    monkeypatch.setattr(program.port(), "engine", SimpleNamespace())
    assert reader(name).read(rd) is None
    monkeypatch.undo()
    # an untraced run reads no per-layer metric from the records
    install(monkeypatch, records(TICKS + CELLS, TICK_TOTALS))
    assert reader(name).read(SimpleNamespace(trace=None, traced=None)) \
        is None


def test_the_new_entries_are_per_layer_metrics_of_their_cells():
    entries = {m["name"]: m for m in MAN["per_layer"]}
    names = [m["name"] for m in MAN["per_layer"]]
    # appended after the first entries as one block, in order; later
    # entries may follow it
    start = names.index(next(iter(NEW)))
    assert names[start:start + len(NEW)] == list(NEW)
    assert set(FIRST) <= set(names[:start])
    moves = {"sweep-paper-policies": "cells_per_s"}
    for name, cells in NEW.items():
        m = entries[name]
        assert m["workloads"] == cells
        assert m["moves"] == moves.get(cells[0], "ticks_per_s")
        assert m["layer"] in ("tick driver", "scheduling", "sweep driver")
        assert (m["better"] == "higher") == (name == "admitted_share")
        assert (ROOT / "dcbench" / "metrics" / f"{name}.py").is_file()


# ---------------------------------------------------------------------------
# A small traced run on the CPU, through the harness
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with a small fleet and three small mixes,
    the new metrics listed for them."""
    r = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", r)
    shutil.copytree(ROOT / "dcbench", r / "dcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = r / "dcbench"
    cfg = json.loads((bench / "configs" / "dcsim-paper-testbed.json")
                     .read_text())
    cfg["name"] = "tiny"
    cfg["fleet"].update(hosts=30, leaves=6)
    cfg["sim"].update(n_jobs=30, n_tasks=90, n_containers=90,
                      arrival_window=10.0)
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    limits = {n: json.loads((bench / "traffic" / f"{mix}.json")
                            .read_text())["limits"]
              for n, mix in (("episode", "table6-burst"),
                             ("grid", "policy-grid"))}
    episode = {"driver": "episode", "arrival": "paper", "base_seed": 0,
               "policy": "netaware",
               "sim": {"horizon": 24, "delay_update_interval": 8},
               "limits": limits["episode"]}
    mixes = {
        "tiny-burst": dict(episode, plan={"chunk": 8}),
        "tiny-telescoped": dict(episode, plan={"chunk": 8,
                                               "telescope": True}),
        "tiny-grid": {"driver": "grid", "arrival": "paper", "base_seed": 0,
                      "policies": ["firstfit", "netaware"],
                      "scenarios": [{"name": "baseline"}],
                      "sim": {"horizon": 12, "delay_update_interval": 8},
                      "plan": {"chunk": 8, "slab": 2},
                      "limits": limits["grid"]}}
    for name, mix in mixes.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    man = json.loads((r / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny", "source": "test",
                           "file": "dcbench/configs/tiny.json",
                           "reduced": [], "why": "test"})
    for name in mixes:
        man["workloads"].append({"name": name, "config": "tiny",
                                 "traffic": name, "chips": 1, "why": "t"})
    twin = {"sim100-burst": "tiny-burst",
            "sim100-telescoped": "tiny-telescoped",
            "sweep-paper-policies": "tiny-grid"}
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [twin[w] for w in m["workloads"] if w in twin]
    (r / "BENCHMARK.json").write_text(json.dumps(man))
    return r


@pytest.fixture(autouse=True)
def no_module_check(monkeypatch):
    """Other test files of this process load JAX to compare the port with
    it; a run's own check of its modules is tested apart."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


@pytest.mark.parametrize("cell", ["tiny-burst", "tiny-telescoped",
                                  "tiny-grid"])
def test_a_traced_run_reads_the_ports_records(root, cell):
    out = harness.run_cell(cell, 2**31 + 21, 0.2, True, device="cpu",
                           root=root)
    assert out["correct"] is True
    got = {k: v["value"] for k, v in out["metrics"].items()}
    twin = {"tiny-burst": "sim100-burst",
            "tiny-telescoped": "sim100-telescoped",
            "tiny-grid": "sweep-paper-policies"}[cell]
    # no device events on the CPU: the device-trace share reads nothing
    want = {n for n, cells in NEW.items() if twin in cells} \
        - {"admit_idle_share"}
    assert want <= set(got) and "admit_idle_share" not in got
    for name in want:
        assert got[name] >= 0, name
    if cell != "tiny-grid":
        assert got["syncs_per_tick"] >= 2      # admit count, migration
        assert 0 < got["admitted_share"] <= 1
        assert got["admit_ms_per_candidate"] > 0
    else:
        assert got["cell_self_ms_per_cell"] > 0 < got["slab_ms_per_cell"]
