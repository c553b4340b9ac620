"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by its file name (CPU, no card)."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "dcbench"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MAN) == KEYS
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for w in cmd[1:]:
        if "/" in w or w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in MAN["paths"]), w
    assert isinstance(MAN["run_seconds"], int) \
        and 1 <= MAN["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lengths():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
        names.append(("cell", w["name"]))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    assert len(names) == len(set(names))
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) \
        == len(MAN["workloads"])


def test_end_to_end_metrics_and_bounds():
    e2e = MAN["end_to_end"]
    assert 1 <= len(e2e) <= 16
    for m in e2e:
        allowed = {"name", "unit", "better", "bound", "source", "workloads"}
        assert set(m) <= allowed and m["source"] in ("host_clock",
                                                     "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in e2e}


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    layers = set()
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells), \
                (m["name"], cell)
        layers.add(m["layer"])
    for w in MAN["workloads"]:
        reported = [m for m in MAN["end_to_end"]
                    if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(w["name"] in m.get("workloads", cells)
                   for m in MAN["per_layer"])
    # roofline shares are percentages
    for m in MAN["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_piece_is_found_by_its_file_name():
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert c["name"] in used
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith("dcbench/")
        config = json.loads(f.read_text())
        assert config["name"] == c["name"]
        # the fabric its fleet names, on the program's side and the
        # reference's
        topology = config["fleet"].get("topology", "spine_leaf")
        assert NAME.match(topology)
        assert (BENCH / "topologies" / f"{topology}.py").is_file()
        assert (BENCH / "reference" / "topologies"
                / f"{topology}.py").is_file()
        files.add(c["file"])
    assert len(files) == len(MAN["configs"])
    for w in MAN["workloads"]:
        traffic = json.loads((BENCH / "traffic"
                              / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        # an episode mix follows the program's delay refreshes and is
        # judged by its delay gap too
        want = {"decisions_differ", "state_gap", "summary_gap"}
        if traffic["driver"] == "episode":
            want.add("delay_gap")
        assert set(traffic["limits"]) == want
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_load_cell_finds_each_cell(cell):
    from dcbench import harness
    spec = harness.load_cell(cell)
    assert spec.cell["name"] == cell
    assert set(spec.readers) == {m["name"] for m in
                                 spec.end_to_end + spec.per_layer}
    assert all(hasattr(r, "read") for r in spec.readers.values())
    assert spec.sim["horizon"] >= 1
