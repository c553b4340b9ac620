"""repro_torch's scenario layer and sweep: against the port's standalone
runs and against repro.core.scenario / repro.launch.sweep.

* ``bursty_workload``, ``mixed_hosts`` for every mix and
  ``build_scenarios(default_scenarios())`` over two seeds: every leaf the
  JAX package's exactly;
* a 2-policy x 2-scenario x 2-seed grid: each stacked cell bit for bit the
  port's standalone ``run_sim`` of that cell; the streamed sweep (chunk 17,
  slab 5, so the last slab is short; overlap on and off) equal to the stacked
  one (finals bit for bit, summary ints exactly, floats rtol 3e-6); the
  stacked grid within the whole-run tolerances of the JAX package's
  (ints exactly, floats rtol 1e-5 / atol 1e-4);
* the tables, the topology and weight-length guards, ``run_sim_vmapped``
  and ``launch.sweep.main``.
"""
import contextlib
import functools
import io

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.core import (HOST_MIXES, SimConfig, get_policy,  # noqa: E402
                              mixed_hosts, run_sim, summarize, sweep_table,
                              tune_table)
from repro_torch.core.convert import assert_state_close  # noqa: E402
from repro_torch.core.scenario import (ScenarioSpec,  # noqa: E402
                                       build_scenario, build_scenarios,
                                       default_scenarios)
from repro_torch.core.types import (ExecPlan, PolicyParams,  # noqa: E402
                                    tree_map)
from repro_torch.core.workload import bursty_workload  # noqa: E402
from repro_torch.launch import sweep as tsweep  # noqa: E402

SMALL = dict(n_jobs=10, n_tasks=40, n_containers=40, horizon=40,
             arrival_window=10.0, placements_per_tick=16,
             migrations_per_tick=2)
HOSTS = dict(n_hosts=8, n_spine=2, n_leaf=4)
POLICIES = ["netaware", "overload_migrate"]
SEEDS = (0, 3)
RTOL, ATOL = 1e-5, 1e-4
INT_KEYS = ("total_arrivals", "total_decisions", "total_migration_starts",
            "flow_ticks", "peak_running", "peak_deployed", "peak_overloaded",
            "peak_queue", "n_completed", "total_migrations", "n_containers",
            "seed")


def scenarios():
    return [ScenarioSpec("slow_net", bw=200.0),
            ScenarioSpec("bursty_premium", arrival="bursty",
                         host_mix="premium", overload_threshold=0.5)]


def leaves(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for sub in tree for x in leaves(sub)]
    return [tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)]


def assert_bitwise(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape and x.dtype == y.dtype, i
        x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), i


def assert_rows_match(a, b, rtol=3e-6):
    assert a.keys() == b.keys()
    for k, va in a.items():
        vb = b[k]
        if k in INT_KEYS or not isinstance(va, float):
            assert va == vb, (k, va, vb)
        elif not (np.isnan(va) and np.isnan(vb)):
            assert va == pytest.approx(vb, rel=rtol), (k, va, vb)


@functools.lru_cache(maxsize=None)
def sweep(chunk=None, slab=None, overlap=True):
    return tsweep.run_sweep(policies=POLICIES, scenarios=scenarios(),
                            seeds=SEEDS, cfg=SimConfig(**SMALL),
                            plan=ExecPlan(chunk=chunk, slab=slab,
                                          overlap=overlap),
                            device="cpu", **HOSTS)


@functools.lru_cache(maxsize=None)
def jax_sweep():
    import jax
    from repro.core import SimConfig as JSimConfig
    from repro.core.scenario import ScenarioSpec as JSpec
    from repro.launch.sweep import run_sweep as jrun_sweep
    specs = [JSpec(**{f: getattr(s, f) for f in s.__dataclass_fields__})
             for s in scenarios()]
    res = jrun_sweep(policies=POLICIES, scenarios=specs, seeds=SEEDS,
                     cfg=JSimConfig(**SMALL), **HOSTS)
    res.summaries()
    return res, jax.device_get(res.finals), jax.device_get(res.metrics)


# ---------------------------------------------------------------------------
# The scenario layer against the JAX package: identical inputs
# ---------------------------------------------------------------------------
def test_bursty_workload_matches_jax_exactly():
    from repro.core import SimConfig as JSimConfig
    from repro.core.workload import bursty_workload as jbursty
    kw = dict(n_jobs=40, n_tasks=120, n_containers=120)
    for seed in (0, 5):
        j = jbursty(JSimConfig(**kw), seed=seed)
        t = bursty_workload(SimConfig(**kw), seed=seed, device="cpu")
        assert_state_close(j, t, rtol=0.0, atol=0.0)
    # flash crowds: arrivals cluster, far from the paper's uniform window
    sub = t.submit_t[torch.isfinite(t.submit_t)]
    assert sub.unique().numel() < sub.numel()


@pytest.mark.parametrize("mix", sorted(HOST_MIXES))
def test_mixed_hosts_match_jax_exactly(mix):
    from repro.core.datacenter import mixed_hosts as jmixed
    assert_state_close(jmixed(mix, 20, 4), mixed_hosts(mix, 20, 4, "cpu"),
                       rtol=0.0, atol=0.0)


def test_build_scenarios_match_jax_exactly():
    from repro.core import SimConfig as JSimConfig
    from repro.core.scenario import build_scenarios as jbuild
    from repro.core.scenario import default_scenarios as jdefault
    cfg = dict(SMALL)
    jspec, jsims, jrp = jbuild(jdefault(), JSimConfig(**cfg), seeds=SEEDS,
                               **HOSTS)
    tspec, tsims, trp = build_scenarios(default_scenarios(),
                                        SimConfig(**cfg), seeds=SEEDS,
                                        device="cpu", **HOSTS)
    assert (tspec.n_hosts, tspec.n_nodes) == (jspec.n_hosts, jspec.n_nodes)
    assert tuple(tsims.t.shape) == (5, 2)
    assert_state_close(jsims, tsims, rtol=0.0, atol=0.0)
    assert_state_close(jrp, trp, rtol=0.0, atol=0.0)
    assert [s.name for s in default_scenarios()] == \
        [s.name for s in jdefault()]


def test_scenario_run_params_override_and_keep():
    cfg = SimConfig(**SMALL)
    keep = ScenarioSpec("keep").run_params(cfg, "cpu")
    base = cfg.run_params("cpu")
    for a, b in zip(keep, base):
        assert torch.equal(a, b) and a.dtype == torch.float32 and a.dim() == 0
    rp = ScenarioSpec("x", bw=200.0, loss=0.02, queue_coef=1.0,
                      overload_threshold=0.5, idle_threshold=0.4,
                      tau=0.3).run_params(cfg, "cpu")
    assert [float(v) for v in rp] == pytest.approx(
        [200.0, 0.02, 1.0, 0.5, 0.4, 0.3])
    assert float(keep.bw_mbps) <= 0 and float(keep.loss) < 0  # sentinels
    for bad in (dict(bw=0.0), dict(loss=-0.1), dict(tau=0.0)):
        with pytest.raises(ValueError):
            ScenarioSpec("bad", **bad)
    with pytest.raises(KeyError, match="arrival"):
        ScenarioSpec("bad", arrival="poisson")


# ---------------------------------------------------------------------------
# The grid against the port's standalone runs and the streamed sweep
# ---------------------------------------------------------------------------
def standalone(policy, spec, seed):
    cfg = SimConfig(**SMALL)
    net_spec, sims, rp = build_scenario(spec, cfg, seeds=(seed,),
                                        device="cpu", **HOSTS)
    return run_sim(tree_map(lambda x: x[0], sims), cfg,
                   get_policy(policy, device="cpu"), net_spec.n_hosts,
                   net_spec.n_nodes, cfg.horizon, params=rp)


def test_sweep_cells_equal_standalone_runs_bit_for_bit():
    res = sweep()
    assert res.compile_cache_misses == 0 and res.n_devices == 1
    assert tuple(res.finals.t.shape) == (2, 2, 2)
    assert tuple(res.metrics.t.shape) == (2, 2, 2, SMALL["horizon"])
    rows = res.summaries()
    for p, pol in enumerate(POLICIES):
        for s, spec in enumerate(scenarios()):
            for n, seed in enumerate(SEEDS):
                f, m = standalone(pol, spec, seed)
                cell = lambda x: x[p, s, n]
                assert_bitwise(tree_map(cell, res.finals), f)
                assert_bitwise(tree_map(cell, res.metrics), m)
                row = rows[(p * 2 + s) * 2 + n]
                assert (row["policy"], row["scenario"], row["seed"]) == \
                    (pol, spec.name, seed)
                want = summarize(f, m)
                assert {k: row[k] for k in want} == pytest.approx(
                    want, nan_ok=True)
    assert any(r["total_migration_starts"] for r in rows)


@pytest.mark.parametrize("overlap", [True, False])
def test_streamed_sweep_equals_stacked(overlap):
    stacked, streamed = sweep(), sweep(chunk=17, slab=5, overlap=overlap)
    assert streamed.metrics is None and streamed.summary is not None
    assert isinstance(streamed.finals.t, np.ndarray)
    assert_bitwise(stacked.finals, streamed.finals)
    assert int(streamed.summary.n_ticks.min()) == SMALL["horizon"]
    for a, b in zip(stacked.summaries(), streamed.summaries()):
        assert_rows_match(a, b)


def test_iter_slabs_wrap_pads_the_last_slab():
    """The port pads no slab (the JAX sweep wrap-pads its last one to keep
    a jit shape): a start owns its own cells only, so the last slab of 8
    cells in slabs of 5 holds cells 5, 6, 7, each equal to the whole
    sweep's."""
    cfg = SimConfig(**SMALL)
    net_spec, sims, rps = build_scenarios(scenarios(), cfg, seeds=SEEDS,
                                          device="cpu", **HOSTS)
    pols = tsweep.stack_policies(POLICIES, device="cpu")
    fn = tsweep.make_stream_fn(cfg, net_spec.n_hosts, net_spec.n_nodes,
                               cfg.horizon, chunk=17, slab=5)
    assert fn.slab_cells(8) == 5 and fn.slab_cells(3) == 3
    (s0, host, summ), = list(fn.iter_slabs(sims, pols, rps, [5]))
    assert s0 == 5 and summ.n_ticks.shape == (3,)
    finals, summary = fn(sims, pols, rps)
    statics = tsweep._static_indices(sims)
    whole = [x for _, x in tsweep.tree_leaves_with_path(finals)]
    for i, x in enumerate(host):
        want = whole[i][0, 0, 0] if i in statics else \
            whole[i].reshape((8,) + whole[i].shape[3:])[5:]
        assert np.array_equal(x, want)
    for a, b in zip(summ, summary):
        assert np.array_equal(a, b.reshape(8)[5:])


def test_stacked_sweep_matches_jax():
    jres, jfinals, jmetrics = jax_sweep()
    res = sweep()
    assert_state_close(jfinals, res.finals, RTOL, ATOL)
    assert_state_close(jmetrics, res.metrics, RTOL, ATOL)
    for a, b in zip(jres.summaries(), res.summaries()):
        assert a.keys() == b.keys()
        for k, va in a.items():
            if k in INT_KEYS or not isinstance(va, float):
                assert b[k] == va, k
            else:
                np.testing.assert_allclose(b[k], va, rtol=RTOL, err_msg=k)


def test_tables_match_jax_on_the_same_rows():
    from repro.core.report import sweep_table as jsweep_table
    from repro.core.report import tune_table as jtune_table
    jrows = jax_sweep()[0].summaries()
    for value in ("avg_runtime", "total_cost", "peak_queue"):
        assert sweep_table(jrows, value) == jsweep_table(jrows, value)
    r = np.random.default_rng(0)
    W = np.tile(get_policy("netaware", device="cpu").weights.numpy(), (6, 1))
    W[1:, [0, 7]] = r.uniform(0, 2, (5, 2))
    scores = r.uniform(0, 10, 6)
    scores[2] = np.nan
    for minimize in (True, False):
        assert tune_table(W, scores, "avg_runtime", top=4,
                          minimize=minimize) == \
            jtune_table(W, scores, "avg_runtime", top=4, minimize=minimize)


# ---------------------------------------------------------------------------
# Guards, the seed-batched run and the CLI
# ---------------------------------------------------------------------------
def test_grid_with_differing_topology_raises():
    cfg = SimConfig(**SMALL)
    net_spec, sims, rps = build_scenarios(scenarios(), cfg, seeds=SEEDS,
                                          device="cpu", **HOSTS)
    pl = sims.net.path_links.clone()
    pl[1, 0, 0, 1, 0] = 5
    bad = sims._replace(net=sims.net._replace(path_links=pl))
    pols = tsweep.stack_policies(POLICIES, device="cpu")
    for fn in (tsweep.make_sweep_fn(cfg, 8, 14, 2),
               tsweep.make_stream_fn(cfg, 8, 14, 2, chunk=1)):
        with pytest.raises(ValueError, match="net.path_links"):
            out = fn(bad, pols, rps)
            assert out is None
    with pytest.raises(ValueError, match="canonical length"):
        tsweep.stack_policies(["netaware",
                               PolicyParams(weights=torch.zeros(5))],
                              device="cpu")
    with pytest.raises(NotImplementedError, match="multi-process fabric"):
        tsweep.make_sweep_fn(cfg, 8, 14, 2, devices=2)
    with pytest.raises(NotImplementedError, match="autodiff"):
        tsweep.make_grad_fn(cfg, 8, 14, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsweep.run_sweep(policies=POLICIES, cfg=cfg)


def test_sweep_leaves_its_inputs_untouched():
    cfg = SimConfig(**dict(SMALL, horizon=12))
    net_spec, sims, rps = build_scenarios(scenarios(), cfg, seeds=SEEDS,
                                          device="cpu", **HOSTS)
    pols = tsweep.stack_policies(POLICIES, device="cpu")
    before = (tree_map(torch.clone, sims), tree_map(torch.clone, rps))
    tsweep.make_stream_fn(cfg, net_spec.n_hosts, net_spec.n_nodes, 12,
                          chunk=5)(sims, pols, rps)
    tsweep.make_sweep_fn(cfg, net_spec.n_hosts, net_spec.n_nodes,
                         12)(sims, pols, rps)
    assert_bitwise(before[0], sims)
    assert_bitwise(before[1], rps)


@pytest.mark.parametrize("chunk", [None, 9])
def test_run_sim_vmapped_equals_per_seed_runs(chunk):
    cfg = SimConfig(**dict(SMALL, horizon=20))
    spec = ScenarioSpec("slow_net", bw=200.0)
    net_spec, sims, rp = build_scenario(spec, cfg, seeds=SEEDS,
                                        device="cpu", **HOSTS)
    pol = get_policy("overload_migrate", device="cpu")
    finals, metrics = tsweep.run_sim_vmapped(sims, cfg, pol, net_spec.n_hosts,
                                             net_spec.n_nodes, 20, rp,
                                             chunk=chunk)
    for n in range(len(SEEDS)):
        f, m = run_sim(tree_map(lambda x: x[n], sims), cfg, pol,
                       net_spec.n_hosts, net_spec.n_nodes, 20, params=rp,
                       plan=ExecPlan(chunk=chunk))
        cell = lambda x: x[n]
        assert_bitwise(tree_map(cell, finals), f)
        assert_bitwise(tree_map(cell, metrics), m)


def test_sweep_cli_runs_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tsweep.main(["--device", "cpu", "--policies", "firstfit,netaware",
                     "--hosts", "20", "--horizon", "10"])
    head, *table = out.getvalue().strip().splitlines()
    assert head.startswith("# 10 cells (2 policies x 5 scenarios x 1 seeds)")
    assert "device=cpu" in head and "waterfill=auto(-> plain)" in head
    assert table[0] == "avg_runtime (mean over seeds)"
    assert len(table) == 2 + 5
