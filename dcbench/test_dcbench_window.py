"""The window closes at the first unit boundary after its seconds, under a
fake clock, and the drivers' units are the episodes and grids they say
(CPU, no card)."""
import json
from types import SimpleNamespace

import pytest
import torch

from dcbench import harness


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("seconds,step,units", [
    (10.0, 3.0, 4), (9.0, 3.0, 3), (0.5, 3.0, 1), (30.0, 7.5, 4)])
def test_window_closes_at_the_first_unit_boundary_after_its_seconds(
        seconds, step, units):
    clock = FakeClock()

    def unit():
        clock.now += step
        return 16

    work, wall, times = harness.measure(unit, seconds, clock)
    assert times == [step] * units and work == 16 * units
    assert wall == pytest.approx(step * units) and wall >= seconds
    assert wall - step < seconds


def test_a_traced_window_runs_until_its_traced_unit():
    clock = FakeClock()
    seen = []

    def unit():
        clock.now += 3.0
        seen.append(clock.now)
        return 1

    work, wall, times = harness.measure(unit, 4.0, clock,
                                        done=lambda: len(seen) >= 5)
    assert work == 5 and wall == 15.0


def small_ctx(traffic):
    fleet = {"hosts": 20, "host_categories": "paper-table5", "leaves": 4,
             "spines": 2, "link_bw_mbps": 1000.0, "link_loss": 0.0,
             "link_delay_ms": 0.05}
    spec = harness.load_cell("sweep-paper-policies")
    sim = dict(spec.config["sim"])
    sim.update(n_jobs=20, n_tasks=60, n_containers=60, arrival_window=8.0)
    sim.update(traffic["sim"])
    return SimpleNamespace(config={"fleet": fleet},
                           topology=harness.load_topology(fleet),
                           traffic=traffic, sim=sim, seed=2**31 + 3,
                           device=torch.device("cpu"))


@pytest.mark.parametrize("telescope", [False, True])
def test_episode_units_are_chunks_back_to_back(telescope):
    """An episode unit is one ``run_sim`` over the whole horizon, which
    streams it in chunks back to back; every episode is one answer."""
    from dcbench.drivers.episode import Driver
    traffic = {"driver": "episode", "arrival": "paper", "base_seed": 0,
               "policy": "netaware",
               "sim": {"horizon": 20, "delay_update_interval": 10},
               "plan": {"chunk": 8, "telescope": telescope}}
    d = Driver(small_ctx(traffic))
    d.setup()
    d.warm()
    sizes = [d.unit() for _ in range(3)]
    assert sizes == [20, 20, 20]
    assert len(d.episodes) == 3 and d.counters() == {"ticks": 60}
    d.close()
    assert d.n_answers == 3
    (a, sa), (b, sb) = d.results[:2]
    for k in a:
        assert (a[k] == b[k]).all(), k   # one answer, every episode
    assert all(sa[k] == sb[k] for k in sa)


def test_an_episode_unit_runs_every_chunk_of_an_episode(monkeypatch):
    from dcbench.drivers.episode import Driver
    from dcbench import program
    eng = program.port().engine
    chunks = []
    real = eng.stream_chunks

    def counted(*args, on_chunk=None, **kwargs):
        if on_chunk is None:
            *args, on_chunk = args
        return real(*args, lambda acc: (chunks.append(1), on_chunk(acc)),
                    **kwargs)

    monkeypatch.setattr(eng, "stream_chunks", counted)
    traffic = {"driver": "episode", "arrival": "paper", "base_seed": 0,
               "policy": "netaware",
               "sim": {"horizon": 20, "delay_update_interval": 10},
               "plan": {"chunk": 8, "telescope": True}}
    d = Driver(small_ctx(traffic))
    d.setup()
    assert [d.unit() for _ in range(2)] == [20, 20]
    assert len(d.episodes) == 2 and len(chunks) == 2 * 3


def test_the_first_episode_keeps_its_delay_refreshes():
    """The window's first episode keeps the matrix of each of its delay
    refreshes (ticks 0 and 10 of 20), no later episode adds any, and
    the port's function is its own again once the window has closed."""
    from dcbench.drivers.episode import Driver
    from dcbench import program
    net = program.port().network
    real = net.update_delay_matrix
    traffic = {"driver": "episode", "arrival": "paper", "base_seed": 0,
               "policy": "firstfit",
               "sim": {"horizon": 20, "delay_update_interval": 10},
               "plan": {"chunk": 8}}
    d = Driver(small_ctx(traffic))
    d.setup()
    d.warm()
    d.unit()
    d.unit()
    d.close()
    assert net.update_delay_matrix is real
    assert len(d.delays) == 2
    assert tuple(d.delays[0].shape) == (20, 20)
    assert d.check()[0]["delay_gap"] == 0.0


def test_grid_units_are_whole_grids_over_successive_seeds(monkeypatch):
    from dcbench.drivers import grid
    from dcbench.drivers.grid import Driver
    traffic = {"driver": "grid", "arrival": "paper", "base_seed": 0,
               "policies": ["firstfit", "netaware"],
               "scenarios": [{"name": "baseline"}], "seeds_per_grid": 2,
               "sim": {"horizon": 6, "delay_update_interval": 5},
               "plan": {"chunk": 4, "slab": 3}}
    d = Driver(small_ctx(traffic))
    d.setup()
    d.warm()
    assert [d.unit() for _ in range(2)] == [4, 4]
    assert d.seeds(1) == [2**31 + 5, 2**31 + 6]
    assert d.counters() == {"ticks": 48, "cells": 8}
    d.close()
    picked = d.sample()
    assert sorted(picked) == [(g, p, 0, n) for g in range(2)
                              for p in range(2) for n in range(2)]
    monkeypatch.setattr(grid, "REFERENCE_CELLS", 3)
    picked = d.sample()
    assert len(picked) == 3 and len(set(picked)) == 3
    assert picked == d.sample()       # drawn from the seed
    monkeypatch.undo()
    assert all(r["decisions_differ"] == 0 and r["state_gap"] == 0.0
               for r in d.check())


def test_each_traffic_file_is_plain_data():
    from pathlib import Path
    for f in (Path(harness.BENCH) / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        assert {"driver", "plan", "limits"} <= set(t)
