"""The comparison that decides ``correct`` must fail its control and the
faults a cell can have, and a cell can be added as files alone; at a
size a test run holds, on the CPU (the control at the cells' own sizes
runs on the card: ``python3 dcbench/control.py``)."""
import json
import shutil
from pathlib import Path

import pytest
import torch

from dcbench import compare, control, harness, program

BENCH = Path(harness.BENCH)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with throwaway cells added as new files and
    new manifest entries only: a small fleet, an episode mix, a grid mix
    and a per-layer metric."""
    r = tmp_path_factory.mktemp("bench")
    shutil.copy(BENCH.parent / "BENCHMARK.json", r)
    shutil.copytree(BENCH, r / "dcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((BENCH / "configs" / "dcsim-paper-testbed.json")
                     .read_text())
    cfg["name"] = "tiny"
    cfg["fleet"].update(hosts=30, leaves=6)
    cfg["sim"].update(n_jobs=30, n_tasks=90, n_containers=90,
                      arrival_window=10.0)
    (r / "dcbench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    limits = {n: json.loads((BENCH / "traffic" / f"{mix}.json")
                            .read_text())["limits"]
              for n, mix in (("episode", "table6-burst"),
                             ("grid", "policy-grid"))}
    mixes = {
        "tiny-episode": {"driver": "episode", "arrival": "paper", "base_seed": 0,
                         "policy": "netaware",
                         "sim": {"horizon": 24, "delay_update_interval": 8},
                         "plan": {"chunk": 8}, "limits": limits["episode"]},
        "tiny-grid": {"driver": "grid", "arrival": "paper", "base_seed": 0,
                      "policies": ["firstfit", "netaware", "round",
                                   "jobgroup"],
                      "scenarios": [{"name": "baseline"}],
                      "sim": {"horizon": 16, "delay_update_interval": 8},
                      "plan": {"chunk": 8, "slab": 4},
                      "limits": limits["grid"]}}
    for name, mix in mixes.items():
        (r / "dcbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    (r / "dcbench" / "metrics" / "ticks_in_window.py").write_text(
        '"""ticks_in_window: ticks the window simulated."""\n\n\n'
        'def read(rd):\n    return rd.counters["ticks"]\n')
    man = json.loads((r / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny", "source": "test",
                           "file": "dcbench/configs/tiny.json",
                           "reduced": [], "why": "test"})
    for name in mixes:
        man["workloads"].append({"name": name, "config": "tiny",
                                 "traffic": name, "chips": 1, "why": "t"})
    for m in man["end_to_end"]:
        if m["name"] == "ticks_per_s":
            m["workloads"].append("tiny-episode")
        if m["name"] == "cells_per_s":
            m["workloads"].append("tiny-grid")
    man["per_layer"].append({
        "name": "ticks_in_window", "unit": "ticks", "better": "higher",
        "source": "program_counter", "layer": "tick driver",
        "moves": "ticks_per_s", "workloads": ["tiny-episode"]})
    (r / "BENCHMARK.json").write_text(json.dumps(man))
    return r


@pytest.fixture(autouse=True)
def no_module_check(monkeypatch):
    """Other test files of this process load JAX to compare the port with
    it; a run's own check of its modules is tested apart
    (test_dcbench_imports.py) and in a process of its own."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])


def run(root, name, seed=2**31 + 11, trace=False):
    return harness.run_cell(name, seed, 0.2, trace, device="cpu", root=root)


def test_a_cell_added_as_files_runs_and_reports_its_metrics(root):
    out = run(root, "tiny-episode")
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"ticks_per_s", "setup_s"}
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(compare.NUMBERS)
    traced = run(root, "tiny-episode", trace=True)
    assert traced["correct"] is True
    assert traced["metrics"]["ticks_in_window"]["value"] >= 24
    grid = run(root, "tiny-grid")
    assert grid["correct"] is True and grid["attempted"] == 4
    assert set(grid["metrics"]) == {"cells_per_s", "setup_s"}


@pytest.mark.parametrize("name", ["tiny-episode", "tiny-grid"])
def test_the_control_fails_the_limits(root, name):
    limits = harness.load_cell(name, root).traffic["limits"]
    for seed in (1, 2, 3):
        readings = control.control_readings(name, seed, "cpu", root=root)
        correct, failed, _ = compare.judge(readings, limits)
        assert not correct and failed >= 1, (seed, readings)


def test_a_tick_that_returns_its_state_unchanged_is_not_correct(
        root, monkeypatch):
    eng = program.port().engine
    real = eng.make_tick

    def frozen(*args):
        tick = real(*args)
        return lambda sim, tt: (sim, tick(sim, tt)[1])

    monkeypatch.setattr(eng, "make_tick", frozen)
    assert run(root, "tiny-episode")["correct"] is False


def test_an_answer_altered_where_it_is_produced_is_not_correct(
        root, monkeypatch):
    eng = program.port().engine
    real = eng.run_sim_chunked

    def altered(sim0, cfg, policy, H, *args, **kwargs):
        sim, online = real(sim0, cfg, policy, H, *args, **kwargs)
        host = sim.containers.host.clone()
        host[0] = (host[0] + 1) % H
        return sim._replace(containers=sim.containers._replace(
            host=host)), online

    monkeypatch.setattr(eng, "run_sim_chunked", altered)
    out = run(root, "tiny-episode")
    assert out["correct"] is False
    assert out["checks"]["decisions_differ"]["value"] >= 1


def tiled_apsp(A, tile=8):
    """Shortest paths over pivot blocks of ``tile`` nodes: another
    association of the path sums than the plain one-pivot loop's."""
    mp = lambda a, b: (a[:, :, None] + b[None, :, :]).amin(dim=1)
    D, n = A.clone(), A.shape[0]
    for k0 in range(0, n, tile):
        k1 = min(k0 + tile, n)
        T = D[k0:k1, k0:k1]
        for p in range(k1 - k0):
            T = torch.minimum(T, T[:, p, None] + T[None, p, :])
        R = torch.minimum(D[k0:k1, :], mp(T, D[k0:k1, :]))
        C = torch.minimum(D[:, k0:k1], mp(D[:, k0:k1], T))
        R[:, k0:k1], C[k0:k1, :] = T, T
        D = torch.minimum(D, mp(C, R))
        D[k0:k1, :], D[:, k0:k1] = R, C
    return D


def test_a_retiled_shortest_path_is_still_correct(root, monkeypatch):
    """The decisions are judged on the program's own refreshed delays: a
    program whose shortest paths group their sums otherwise reads
    correct, its delays within a few ulps of the reference's."""
    net = program.port().network
    monkeypatch.setattr(net, "floyd_warshall_ref", tiled_apsp)
    out = run(root, "tiny-episode")
    assert out["correct"] is True
    assert out["checks"]["delay_gap"]["value"] < 1e-6


def test_a_delay_refresh_off_by_a_thousandth_is_not_correct(
        root, monkeypatch):
    net = program.port().network
    real = net.floyd_warshall_ref
    monkeypatch.setattr(net, "floyd_warshall_ref",
                        lambda A: real(A) * 1.001)
    out = run(root, "tiny-episode")
    assert out["correct"] is False
    assert out["checks"]["delay_gap"]["value"] > 1e-4


def test_half_of_a_grid_left_out_is_not_correct(root, monkeypatch):
    sweep = program.port().sweep
    real = sweep.make_stream_fn

    def half(*args, **kwargs):
        fn = real(*args, **kwargs)

        def run_half(sims, pols, rps):
            # the first half of the policies run; the rest copy them
            P = pols.weights.shape[0]
            if P < 2:       # the warm-up's one-policy grid
                return fn(sims, pols, rps)
            keep = pols._replace(weights=pols.weights[:P // 2])
            finals, summary = fn(sims, keep, rps)
            rep = lambda x: x[[i % (P // 2) for i in range(P)]]
            return (program.port().types.tree_map(rep, finals),
                    type(summary)(*(rep(x) for x in summary)))
        return run_half

    monkeypatch.setattr(sweep, "make_stream_fn", half)
    out = run(root, "tiny-grid")
    assert out["correct"] is False and out["failed"] >= 1
