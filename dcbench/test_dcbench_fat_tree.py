"""The k-ary fat tree as a fabric of the benchmark (CPU, no card): the
port's tables against the plain reference's, entry by entry, at k = 4
and k = 6, with a hand-checked path of each length; a k = 4 episode of
the port bit for bit the reference's, through the harness on a small
configuration and cell; the readers of the network layer's new spans
and counters (``core_flow_share``, ``apsp_ms_per_refresh``,
``comm_cost_ms_per_refresh``) on hand-built records and on a profiled
k = 4 episode, whose flow counts by path length add up to the active
flow-ticks on links; and nothing recorded untraced."""
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dcbench import harness, inputs, program
from dcbench.test_dcbench_port_trace import (TICK_TOTALS, TICKS, install,
                                             reader, records, trace_of)

ROOT = Path(harness.ROOT)
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "fattree1k-backlog"
EPISODE = ["sim100-burst", "sim100-telescoped", CELL]
NEW = {"core_flow_share": [CELL], "apsp_ms_per_refresh": EPISODE,
       "comm_cost_ms_per_refresh": EPISODE}


def fleet(k, hosts=None):
    return {"topology": "fat_tree", "k": k,
            "hosts": k ** 3 // 4 if hosts is None else hosts,
            "host_categories": "paper-table5", "link_bw_mbps": 1000.0,
            "link_loss": 0.0, "link_delay_ms": 0.05}


TOPOLOGY = harness.load_topology(fleet(4))


# ---------------------------------------------------------------------------
# The tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [4, 6])
def test_the_ports_tables_are_the_references_entry_by_entry(k):
    f = fleet(k)
    ref = TOPOLOGY.reference.build_net(f, "cpu")
    net, H, N = TOPOLOGY.port.build(f, "cpu")
    assert H == k ** 3 // 4
    assert N == H + ref["n_switches"] == H + 5 * k * k // 4
    for key in ("link_bw", "link_delay", "link_loss", "link_u", "link_v",
                "path_links", "path_nlinks"):
        assert torch.equal(getattr(net, key), ref[key]), key
    assert net.path_links.shape == (H, H, 6)
    assert net.link_bw.shape == (3 * H,)
    # every link joins two nodes, each pair of nodes at most once
    ends = {tuple(sorted(e)) for e in zip(net.link_u.tolist(),
                                          net.link_v.tolist())}
    assert len(ends) == 3 * H and max(max(e) for e in ends) == N - 1
    # 0 from a host to itself; k/2 - 1 hosts under its edge switch, k/2
    # (k/2) - k/2 more in its pod, the rest across pods
    counts = np.bincount(net.path_nlinks.reshape(-1).numpy(), minlength=7)
    h = k // 2
    assert counts.tolist() == [H, 0, H * (h - 1), 0, H * (h * h - h), 0,
                               H * (H - h * h)]


# k = 4: hosts 0-15, edges 16-23 (pod p's at 16 + 2p), aggregations 24-31,
# cores 32-35; host d on edge d % 8 at index d // 8 under it
@pytest.mark.parametrize("i,j,links", [
    (0, 8, [0, 8]),                    # under edge 0
    (0, 1, [0, 16, 18, 1]),            # pod 0: edge 0 up to aggregation 0
    (9, 0, [9, 19, 17, 0]),            # edge 1 (s = 1), j_dst 0: a = 1
    (0, 9, [0, 17, 19, 9]),            # j_dst 1: a = 1
    (0, 2, [0, 16, 32, 36, 20, 2]),    # pod 0 to 1, a = 0, core port 0
    (0, 10, [0, 17, 34, 38, 21, 10]),  # j_dst 1: a = 1, m = (1 + 1) % 2 = 0
    (3, 14, [3, 22, 37, 45, 28, 14]),  # pod 1 s 1 to pod 3 s 0, j_dst 1:
                                       # a = 0, m = 1
])
def test_hand_checked_paths(i, j, links):
    net, _, _ = TOPOLOGY.port.build(fleet(4), "cpu")
    got = net.path_links[i, j].tolist()
    assert got == links + [-1] * (6 - len(links))
    assert int(net.path_nlinks[i, j]) == len(links)
    # each link of the path joins the node the last one reached
    node = i
    for e in links:
        u, v = int(net.link_u[e]), int(net.link_v[e])
        assert node in (u, v)
        node = v if node == u else u
    assert node == j


@pytest.mark.parametrize("side", ["port", "reference"])
def test_a_fleet_that_is_not_k_cubed_over_4_is_refused(side):
    bad = fleet(4, hosts=20)
    if side == "port":
        with pytest.raises(harness.RunError, match="16 hosts"):
            TOPOLOGY.port.host_switch(bad)
        with pytest.raises(harness.RunError, match="16 hosts"):
            TOPOLOGY.port.build(bad, "cpu")
    else:
        with pytest.raises(ValueError, match="16 hosts"):
            TOPOLOGY.reference.build_net(bad, "cpu")


def test_the_hosts_first_hop_is_their_edge_switch():
    p = program.port()
    want = p.datacenter.scaled_hosts(1024, 128, device="cpu")
    got = inputs.host_tables(TOPOLOGY.port.host_switch(fleet(16)))
    for k in ("cap", "speed", "price", "leaf"):
        np.testing.assert_array_equal(got[k], getattr(want, k).numpy())
    # Table 5's blocks of 256 hosts spread over every edge switch
    assert sorted(set(got["leaf"][:256].tolist())) == list(range(128))


def test_the_cells_kernel_shapes():
    spec = harness.load_cell(CELL)
    assert spec.topology.name == "fat_tree"
    assert spec.topology.port.kernel_shapes(spec.config["fleet"], spec.sim) \
        == {"fw_n": 1344, "waterfill_F": 30720, "waterfill_E": 3072,
            "waterfill_hops": 6}
    assert spec.cell["chips"] == 1 and spec.sim["horizon"] == 300


# ---------------------------------------------------------------------------
# The manifest's new entries
# ---------------------------------------------------------------------------
def test_the_new_per_layer_entries_are_appended_for_their_cells():
    # one block in order after the entries before it, wherever later
    # entries go
    names = [m["name"] for m in MAN["per_layer"]]
    start = names.index(next(iter(NEW)))
    assert start > names.index("place_round_share")
    assert names[start:start + len(NEW)] == list(NEW)
    for m in MAN["per_layer"][start:start + len(NEW)]:
        assert m["workloads"][:len(NEW[m["name"]])] == NEW[m["name"]]
        assert m["layer"] == "network" and m["moves"] == "ticks_per_s"
    ticks = next(m for m in MAN["end_to_end"] if m["name"] == "ticks_per_s")
    assert CELL in ticks["workloads"]


# ---------------------------------------------------------------------------
# The readers on hand-built records
# ---------------------------------------------------------------------------
REFRESH = TICKS + [("apsp", None, 0, 6, 8), ("comm_cost", None, 0, 8, 8.5),
                   ("apsp", None, 4, 14, 18), ("comm_cost", None, 4, 18, 19)]
FLOWS = dict(TICK_TOTALS, flows_2link=5, flows_4link=3, flows_6link=12)


@pytest.mark.parametrize("name,want", [
    ("core_flow_share", 12 / 20),
    ("apsp_ms_per_refresh", (2 + 4) / 2),
    ("comm_cost_ms_per_refresh", (0.5 + 1) / 2)])
def test_network_readers_on_hand_built_records(monkeypatch, name, want):
    install(monkeypatch, records(REFRESH, FLOWS))
    rd = SimpleNamespace(trace=trace_of(0.1, [(0, 1)]), traced={"ticks": 5})
    assert reader(name).read(rd) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(NEW))
@pytest.mark.parametrize("case", ["no_records", "nothing_of_its_own",
                                  "older_port", "untraced"])
def test_network_readers_give_no_value_where_nothing_was_recorded(
        monkeypatch, name, case):
    rows, totals = {"no_records": ([], {}),
                    "nothing_of_its_own": (TICKS, TICK_TOTALS)}.get(
        case, (REFRESH, FLOWS))
    install(monkeypatch, records(rows, totals))
    rd = SimpleNamespace(trace=trace_of(0.1, [(0, 1)]), traced={"ticks": 5})
    if case == "older_port":
        monkeypatch.setattr(program.port(), "engine", SimpleNamespace())
    if case == "untraced":
        rd = SimpleNamespace(trace=None, traced=None)
    assert reader(name).read(rd) is None


def test_a_spine_leaf_unit_reads_no_core_flows(monkeypatch):
    install(monkeypatch, records(TICKS, dict(TICK_TOTALS, flows_2link=4,
                                             flows_4link=6)))
    rd = SimpleNamespace(trace=trace_of(0.1, [(0, 1)]), traced={"ticks": 5})
    assert reader("core_flow_share").read(rd) == 0.0


# ---------------------------------------------------------------------------
# A k = 4 episode
# ---------------------------------------------------------------------------
SIM = {"n_jobs": 16, "n_tasks": 48, "n_containers": 48,
       "arrival_window": 6.0}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with a k = 4 fat-tree configuration and an
    episode cell on it ('fw' refreshes), the network readers listed."""
    r = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", r)
    shutil.copytree(ROOT / "dcbench", r / "dcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = r / "dcbench"
    cfg = json.loads((bench / "configs" / "dcsim-fattree-k16.json")
                     .read_text())
    cfg["name"] = "tiny-fattree"
    cfg["fleet"].update(k=4, hosts=16)
    cfg["sim"].update(SIM)
    (bench / "configs" / "tiny-fattree.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "fattree-backlog.json").read_text())
    mix.update(sim={"horizon": 24, "delay_update_interval": 8},
               plan={"chunk": 8}, reference_device="cpu")
    (bench / "traffic" / "tiny-fattree.json").write_text(json.dumps(mix))
    man = json.loads((r / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-fattree", "source": "test",
                           "file": "dcbench/configs/tiny-fattree.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "tiny-fattree-cell",
                             "config": "tiny-fattree",
                             "traffic": "tiny-fattree", "chips": 1,
                             "why": "t"})
    for m in man["end_to_end"] + man["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-fattree-cell")
    (r / "BENCHMARK.json").write_text(json.dumps(man))
    return r


@pytest.fixture(autouse=True)
def no_module_check(monkeypatch):
    """Other test files of this process load JAX to compare the port with
    it; a run's own check of its modules is tested apart."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def test_a_k4_episode_is_the_references_bit_for_bit(root):
    out = harness.run_cell("tiny-fattree-cell", 2**31 + 77, 0.2, False,
                           device="cpu", root=root)
    assert out["correct"] is True and out["failed"] == 0
    checks = {k: c["value"] for k, c in out["checks"].items()}
    assert checks["decisions_differ"] == 0
    assert checks["state_gap"] == 0.0 and checks["delay_gap"] == 0.0
    assert checks["summary_gap"] < 1e-5      # f32 Kahan chunks against f64


def test_a_traced_k4_episode_reads_the_network_metrics(root):
    out = harness.run_cell("tiny-fattree-cell", 2**31 + 77, 0.2, True,
                           device="cpu", root=root)
    assert out["correct"] is True
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert 0 < got["core_flow_share"] < 1
    assert got["apsp_ms_per_refresh"] > 0 < got["comm_cost_ms_per_refresh"]


def run_k4(monkeypatch, profiled):
    """A k = 4 episode of the port (horizon 24, 'fw' every 8), each flow
    allocation's (src, dst, active) kept; (records, kept, path_nlinks)."""
    from torch.profiler import ProfilerActivity, profile
    p = program.port()
    sim = dict(json.loads((ROOT / "dcbench" / "configs"
                           / "dcsim-fattree-k16.json").read_text())["sim"],
               **SIM, horizon=24, delay_update_interval=8)
    hosts = inputs.host_tables(TOPOLOGY.port.host_switch(fleet(4)))
    cols = inputs.workload(sim, "paper", 5)
    net, H, N = TOPOLOGY.port.build(fleet(4), "cpu")
    sim0 = program.initial_state(hosts, cols, net, "cpu")
    kept, real = [], p.network.flow_rates

    def flow_rates(net, src, dst, active, **kw):
        kept.append((src.clone(), dst.clone(), active.clone()))
        return real(net, src, dst, active, **kw)

    monkeypatch.setattr(p.network, "flow_rates", flow_rates)
    args = (sim0, program.sim_config(sim),
            p.scheduling.get_policy("netaware", device="cpu"), H, N, 24)
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            p.engine.run_sim(*args)
    else:
        p.engine.run_sim(*args)
    return p.engine.trace.snapshot(), kept, net.path_nlinks


def test_profiled_flow_counts_by_length_add_up(monkeypatch):
    snap, kept, nlinks = run_k4(monkeypatch, profiled=True)
    assert len(kept) == 24
    want = {}
    for src, dst, active in kept:
        n = nlinks[src.clamp(min=0).long(), dst.clamp(min=0).long()][active]
        for length in n.tolist():
            if length:
                want[f"flows_{length}link"] = \
                    want.get(f"flows_{length}link", 0) + 1
    got = {k: v for k, v in snap.totals.items() if k.startswith("flows_")}
    assert got == want and set(got) <= {"flows_2link", "flows_4link",
                                        "flows_6link"}
    assert got.get("flows_6link", 0) > 0
    assert len([s for s in snap.spans if s.name == "apsp"]) == 3
    assert len([s for s in snap.spans if s.name == "comm_cost"]) == 3


def test_untraced_nothing_is_recorded(monkeypatch):
    trace = program.port().engine.trace
    before = trace.snapshot()
    made = []
    real = trace.count_device
    monkeypatch.setattr(trace, "count_device", lambda key, make, read: real(
        key, lambda: made.append(1) or make(), read))
    snap, kept, _ = run_k4(monkeypatch, profiled=False)
    assert len(kept) == 24
    # the records of the last profiled window stand as they were, and no
    # device count was made
    assert snap == before and not made
