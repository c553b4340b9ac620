"""A fabric is found by the name a configuration's fleet gives it: a
second topology added as files alone, its program side and its reference
side, carries a small episode cell to a correct run; a reference side
that builds another fabric than the program's is not correct; a name
with no file is refused, naming the file (CPU, no card)."""
import json
import shutil
from pathlib import Path

import pytest

from dcbench import harness

BENCH = Path(harness.BENCH)

# each side delegates to the spine-leaf file beside it
TWIN = '''"""spine_leaf under another name."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "{prefix}spine_leaf", Path(__file__).with_name("spine_leaf.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)
'''
PORT_TWIN = TWIN.format(prefix="twin_port_") + (
    "host_switch, build, kernel_shapes = "
    "base.host_switch, base.build, base.kernel_shapes\n")
REF_TWIN = TWIN.format(prefix="twin_ref_") + "build_net = base.build_net\n"
# the reference side's fabric with every link's delay a thousandth longer
REF_SKEWED = TWIN.format(prefix="skewed_ref_") + '''

def build_net(topo, device):
    net = base.build_net(topo, device)
    return dict(net, link_delay=net["link_delay"] * 1.001)
'''
FABRICS = {"spine_leaf_twin": (PORT_TWIN, REF_TWIN),
           "spine_leaf_skewed": (PORT_TWIN, REF_SKEWED),
           "half_fabric": (PORT_TWIN, None),
           "no_such_fabric": (None, None)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with the fabrics above as new files, a
    small configuration naming each and an episode cell on each."""
    r = tmp_path_factory.mktemp("bench")
    shutil.copy(BENCH.parent / "BENCHMARK.json", r)
    shutil.copytree(BENCH, r / "dcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = r / "dcbench"
    cfg = json.loads((BENCH / "configs" / "dcsim-paper-testbed.json")
                     .read_text())
    cfg["fleet"].update(hosts=30, leaves=6)
    cfg["sim"].update(n_jobs=30, n_tasks=90, n_containers=90,
                      arrival_window=10.0)
    limits = json.loads((BENCH / "traffic" / "table6-burst.json")
                        .read_text())["limits"]
    mix = {"driver": "episode", "arrival": "paper", "base_seed": 0,
           "policy": "netaware",
           "sim": {"horizon": 24, "delay_update_interval": 8},
           "plan": {"chunk": 8}, "limits": limits}
    (bench / "traffic" / "tiny-fabric.json").write_text(json.dumps(mix))
    man = json.loads((r / "BENCHMARK.json").read_text())
    for name, (port, ref) in FABRICS.items():
        if port is not None:
            (bench / "topologies" / f"{name}.py").write_text(port)
        if ref is not None:
            (bench / "reference" / "topologies" / f"{name}.py").write_text(
                ref)
        cfg["name"] = f"tiny-{name}"
        cfg["fleet"]["topology"] = name
        (bench / "configs" / f"tiny-{name}.json").write_text(json.dumps(cfg))
        man["configs"].append({"name": f"tiny-{name}", "source": "test",
                               "file": f"dcbench/configs/tiny-{name}.json",
                               "reduced": [], "why": "test"})
        man["workloads"].append({"name": f"{name}-cell",
                                 "config": f"tiny-{name}",
                                 "traffic": "tiny-fabric", "chips": 1,
                                 "why": "t"})
    for m in man["end_to_end"]:
        if m["name"] == "ticks_per_s":
            m["workloads"] += [f"{n}-cell" for n in FABRICS]
    (r / "BENCHMARK.json").write_text(json.dumps(man))
    return r


@pytest.fixture(autouse=True)
def no_module_check(monkeypatch):
    """Other test files of this process load JAX to compare the port with
    it; a run's own check of its modules is tested apart."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def test_load_cell_finds_the_fabric_its_configuration_names(root):
    spec = harness.load_cell("spine_leaf_twin-cell", root)
    topo = spec.topology
    assert topo.name == "spine_leaf_twin"
    assert Path(topo.port.__file__) == \
        root / "dcbench" / "topologies" / "spine_leaf_twin.py"
    assert Path(topo.reference.__file__) == \
        root / "dcbench" / "reference" / "topologies" / "spine_leaf_twin.py"
    fleet = spec.config["fleet"]
    assert topo.port.kernel_shapes(fleet, spec.sim)["waterfill_hops"] == 4
    # a fleet that names none is spine-leaf
    plain = harness.load_cell("sim100-burst", root).topology
    assert plain.name == "spine_leaf"


def test_a_fabric_added_as_files_runs_correct(root):
    out = harness.run_cell("spine_leaf_twin-cell", 2**31 + 41, 0.2, False,
                           device="cpu", root=root)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["delay_gap"]["value"] == 0.0
    assert set(out["metrics"]) == {"ticks_per_s", "setup_s"}


def test_a_reference_fabric_unlike_the_programs_is_not_correct(root):
    out = harness.run_cell("spine_leaf_skewed-cell", 2**31 + 41, 0.2, False,
                           device="cpu", root=root)
    assert out["correct"] is False
    assert out["checks"]["delay_gap"]["value"] > 1e-4


@pytest.mark.parametrize("cell,missing", [
    ("no_such_fabric-cell", "topologies/no_such_fabric.py"),
    ("half_fabric-cell", "reference/topologies/half_fabric.py")])
def test_a_fabric_with_no_file_is_refused_by_name(root, cell, missing):
    with pytest.raises(harness.RunError, match=missing):
        harness.load_cell(cell, root)


def test_a_fabric_name_that_is_no_name_is_refused(root):
    with pytest.raises(harness.RunError, match="not a name"):
        harness.load_topology({"topology": "../spine_leaf"}, root)
