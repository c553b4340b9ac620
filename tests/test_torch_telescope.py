"""repro_torch event-horizon telescoping: against the port's per-tick runs
and against repro.core's telescoping engine.

* ``stats.acc_update_weighted`` against the JAX package's on the same
  inputs (dt 0, 1, 2, 7, 100, from a non-trivial accumulator): every field
  bit for bit; against dt unit folds (integers exactly, recovered float
  sums rtol 1e-5); dt = 0 a bitwise no-op; split across an ``online_fold``
  chunk boundary;
* ``workload.next_arrival_after``, ``engine._event_horizon`` and the new
  ``TickInfo`` fields against the JAX package's from one identical state:
  equal exactly;
* telescoped == the port's per-tick run for all six policies, unchunked
  and at chunks 17 and 64, over a quiescent tail (horizon 200), with
  ``delay_update_interval=0`` and with the 'fw' refresh: final state bit
  for bit, summary integer keys exactly, float keys rtol 3e-6;
* the port's telescoped run against ``repro.core.engine.run_sim`` with
  ``ExecPlan(telescope=True)`` (final-state ints exactly, floats rtol
  1e-5 / atol 1e-4; ``OnlineSummary`` ints exactly, floats rtol 1e-5),
  and the number of full ticks equal to the JAX package's on a
  quiescent-tail config (horizon 400, refresh every 100);
* ``run_sweep`` and ``run_sim_vmapped`` telescoped, ``run_tune`` (random
  and cem) and ``run_tune_grad`` with ``telescope``, against their
  per-tick twins;
* the refusals: ``soft_placement``, ``--csv`` and several processes.
"""
import contextlib
import dataclasses
import functools
import io
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.core import (SimConfig, get_policy, list_policies,  # noqa: E402
                              run_sim, summarize)
from repro_torch.core import engine, stats, workload  # noqa: E402
from repro_torch.core.convert import (assert_state_close,  # noqa: E402
                                      to_torch)
from repro_torch.core.scenario import (ScenarioSpec,  # noqa: E402
                                       build_scenario, build_scenarios)
from repro_torch.core.types import (ExecPlan, OnlineSummary,  # noqa: E402
                                    SummaryAcc, TickMetrics, tree_map)
from repro_torch.launch import sim as tsim  # noqa: E402
from repro_torch.launch import sweep as tsweep  # noqa: E402
from repro_torch.launch import tune as ttune  # noqa: E402

SMALL = dict(n_jobs=10, n_tasks=40, n_containers=40, horizon=40,
             arrival_window=10.0, placements_per_tick=16,
             migrations_per_tick=2)
HOSTS = dict(n_hosts=8, n_spine=2, n_leaf=4)
RTOL, ATOL = 1e-5, 1e-4
INT_KEYS = ("total_arrivals", "total_decisions", "total_migration_starts",
            "flow_ticks", "peak_running", "peak_deployed", "peak_overloaded",
            "peak_queue", "n_completed", "total_migrations", "n_containers",
            "seed")
TELESCOPE = ExecPlan(telescope=True)


def leaves(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for sub in tree for x in leaves(sub)]
    return [tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)]


def assert_bitwise(a, b):
    """Every leaf of two trees equal bit for bit (shape, dtype, bytes)."""
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape and x.dtype == y.dtype, i
        x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), \
            f"leaf {i}: max |delta| " \
            f"{np.abs(x.astype(np.float64) - y.astype(np.float64)).max()}"


def assert_rows_match(a, b, rtol=3e-6):
    assert a.keys() == b.keys()
    for k, va in a.items():
        vb = b[k]
        if k in INT_KEYS or not isinstance(va, float):
            assert va == vb, (k, va, vb)
        elif not (np.isnan(va) and np.isnan(vb)):
            assert va == pytest.approx(vb, rel=rtol), (k, va, vb)


def assert_online_match(got, want, rtol):
    for f, a, b in zip(OnlineSummary._fields, got, want):
        if np.issubdtype(np.asarray(b).dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=f)


def small(**kw):
    cfg = SimConfig(**{**SMALL, **kw})
    net_spec, sims, rp = build_scenario(ScenarioSpec("baseline"), cfg,
                                        seeds=(0,), device="cpu", **HOSTS)
    return cfg, net_spec, tree_map(lambda x: x[0], sims), rp


def run(policy, plan=None, **kw):
    cfg, net_spec, sim0, rp = small(**kw)
    return run_sim(sim0, cfg, get_policy(policy, device="cpu"),
                   net_spec.n_hosts, net_spec.n_nodes, cfg.horizon,
                   params=rp, plan=plan)


# ---------------------------------------------------------------------------
# The weighted fold
# ---------------------------------------------------------------------------
def synth_metrics(seed=0):
    """One populated tick's metrics as numpy scalars (the JAX test's)."""
    rng = np.random.default_rng(seed)
    i = lambda v: np.asarray(v, np.int32)
    f = lambda v: np.asarray(v, np.float32)
    return TickMetrics(
        t=f(7.0), n_overloaded=i(2), n_inactive=i(1), n_running=i(9),
        n_deployed=i(11), n_communicating=i(4), n_waiting=i(3),
        n_completed=i(5), n_migrating=i(1), new_arrivals=i(0),
        decisions=i(0), migrations=i(0),
        util_variance=f(rng.uniform(0.0, 0.2)),
        mean_util=f(rng.uniform(0.2, 0.9)), active_flows=i(6),
        mean_flow_rate=f(rng.uniform(1.0, 50.0)),
        soft_comm=f(rng.uniform(0.0, 2.0)), soft_util=f(rng.uniform(0, 1)),
        soft_n=f(3.0), soft_mig=f(rng.uniform(0, 1)), soft_mig_n=f(2.0))


def as_torch(m):
    return TickMetrics(*(torch.tensor(x) for x in m))


def dt_of(dt):
    return torch.tensor(dt, dtype=torch.int32)


def unit_folds(acc, m, dt):
    for _ in range(dt):
        acc = stats.acc_update(acc, m)
    return acc


def start_acc(seed=9, n=3):
    """A non-trivial accumulator: ``n`` folds of another tick."""
    return unit_folds(stats.acc_init("cpu"), as_torch(synth_metrics(seed)),
                      n)


@pytest.mark.parametrize("dt", [0, 1, 2, 7, 100])
def test_weighted_fold_matches_jax_bit_for_bit(dt):
    import jax.numpy as jnp
    from repro.core import stats as jstats
    from repro.core.types import TickMetrics as JTickMetrics
    m0, m = synth_metrics(9), synth_metrics(0)
    jacc = jstats.acc_init()
    for _ in range(3):
        jacc = jstats.acc_update(jacc, JTickMetrics(*map(jnp.asarray, m0)))
    want = jstats.acc_update_weighted(jacc, JTickMetrics(*map(jnp.asarray,
                                                              m)),
                                      jnp.asarray(dt, jnp.int32))
    got = stats.acc_update_weighted(start_acc(), as_torch(m), dt_of(dt))
    for f in SummaryAcc._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (f, a, b)


@pytest.mark.parametrize("dt", [1, 2, 7, 100])
def test_weighted_fold_equals_unit_folds(dt):
    """One dt-weighted fold == dt unit folds: integer fields exactly, the
    recovered Kahan sums and the Welford moments within rtol 1e-5 (the
    JAX package's ``assert_acc_close``)."""
    m = as_torch(synth_metrics())
    weighted = stats.acc_update_weighted(start_acc(), m, dt_of(dt))
    repeated = unit_folds(start_acc(), m, dt)
    wd, rd = weighted._asdict(), repeated._asdict()
    for name, a in wd.items():
        a, b = a.numpy(), rd[name].numpy()
        if name.startswith("c_"):
            continue
        if name.startswith("sum_") and ("c_" + name[4:]) in wd:
            a = a.astype(np.float64) + wd["c_" + name[4:]].double().numpy()
            b = b.astype(np.float64) + rd["c_" + name[4:]].double().numpy()
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7,
                                       err_msg=name)
        elif a.dtype.kind == "i":
            assert (a == b).all(), (name, a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7,
                                       err_msg=name)


def test_weighted_fold_dt_zero_is_bitwise_noop():
    acc0 = start_acc(seed=4, n=2)
    assert_bitwise(acc0, stats.acc_update_weighted(
        acc0, as_torch(synth_metrics()), dt_of(0)))


def test_weighted_fold_across_chunk_boundary():
    """One interval split over two accumulators joined by ``online_fold``
    (a chunk boundary inside it) equals the single fold."""
    m = as_torch(synth_metrics(seed=2))
    one = stats.online_fold(stats.online_init(), stats.acc_update_weighted(
        stats.acc_init("cpu"), m, dt_of(10)))
    split = stats.online_init()
    for dt in (4, 6):
        split = stats.online_fold(split, stats.acc_update_weighted(
            stats.acc_init("cpu"), m, dt_of(dt)))
    assert_online_match(split, one, rtol=1e-6)


# ---------------------------------------------------------------------------
# The event horizon and the tick's side outputs, from one identical state
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jax_tick_at(policy, t):
    """The JAX package's state after ``t`` ticks of the small config, and
    the state, metrics and TickInfo of its tick ``t``, as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.core import SimConfig as JSimConfig
    from repro.core import engine as jeng
    from repro.core import get_policy as jget_policy
    from repro.core import run_sim as jrun_sim
    from repro.core.scenario import ScenarioSpec as JSpec
    from repro.core.scenario import build_scenario as jbuild
    cfg = JSimConfig(**SMALL)
    net_spec, sims, rp = jbuild(JSpec("baseline"), cfg, seeds=(0,), **HOSTS)
    pol = jget_policy(policy)
    pre, _ = jrun_sim(jax.tree.map(lambda x: x[0], sims), cfg, pol,
                      net_spec.n_hosts, net_spec.n_nodes, t, params=rp)
    tick = jax.jit(jeng.make_tick_ext(cfg, pol, rp, net_spec.n_hosts,
                                      net_spec.n_nodes))
    post, _, info = tick(pre, jnp.asarray(t, jnp.int32))
    return (jax.device_get(pre), jax.device_get(post), jax.device_get(info),
            jax.device_get(rp), net_spec)


def port_info(info):
    return engine.TickInfo(**{
        f: (bool(info.refreshed) if f == "refreshed"
            else torch.tensor(np.asarray(getattr(info, f))))
        for f in engine.TickInfo._fields})


@pytest.mark.parametrize("policy,t", [("netaware", 5), ("netaware", 8),
                                      ("overload_migrate", 14)])
def test_tick_info_fields_match_jax(policy, t):
    pre, _, jinfo, rp, net_spec = jax_tick_at(policy, t)
    cfg = SimConfig(**SMALL)
    tick = engine.make_tick_ext(cfg, get_policy(policy, device="cpu"),
                                to_torch(rp, "cpu"), net_spec.n_hosts,
                                net_spec.n_nodes)
    _, _, info = tick(to_torch(pre, "cpu"), t)
    assert info._fields == tuple(jinfo._fields)
    for f in ("mid_status", "mid_host", "mid_peer", "mid_mig_dst",
              "flow_active"):
        a, b = np.asarray(getattr(jinfo, f)), getattr(info, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert info.refreshed == bool(jinfo.refreshed) == (t % 10 == 0)
    for f in ("comm_rates", "mig_rates", "all_rates"):
        np.testing.assert_allclose(getattr(info, f).numpy(),
                                   np.asarray(getattr(jinfo, f)), rtol=RTOL,
                                   err_msg=f)


@pytest.mark.parametrize("policy,t", [("netaware", 5), ("netaware", 8),
                                      ("overload_migrate", 14)])
def test_event_horizon_and_next_arrival_match_jax(policy, t):
    import jax.numpy as jnp
    from repro.core import SimConfig as JSimConfig
    from repro.core import engine as jeng
    from repro.core import workload as jworkload
    _, post, jinfo, _, _ = jax_tick_at(policy, t)
    tpost, tinfo = to_torch(post, "cpu"), port_info(jinfo)
    H = post.hosts.cap.shape[0]
    jct = post.containers
    jspeed = np.asarray(post.hosts.speed)[
        np.clip(np.asarray(jct.host), 0, H - 1), np.asarray(jct.ctype)]
    tct = tpost.containers
    tspeed = tpost.hosts.speed[torch.clamp(tct.host, 0, H - 1).long(),
                               tct.ctype.long()]
    np.testing.assert_array_equal(tspeed.numpy(), jspeed)
    finite = 0
    for t_end in (t + 3, (t // 10 + 1) * 10, 1000):
        want = np.asarray(jeng._event_horizon(
            post, JSimConfig(**SMALL), jinfo, jnp.asarray(t, jnp.int32),
            jnp.asarray(t_end, jnp.int32), jnp.asarray(jspeed)))
        got = engine._event_horizon(tpost, tinfo, t, t_end, tspeed)
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), (t_end, got, want)
        finite += bool(np.isfinite(want)) and float(want) < t_end
    assert finite   # an estimate, not only the cap, bounded the horizon
    for q in (0.0, 2.5, float(t), 9.9, 30.0):
        want = np.asarray(jworkload.next_arrival_after(
            jct, jnp.asarray(q, jnp.float32)))
        got = workload.next_arrival_after(tct, torch.tensor(q))
        assert got.numpy().tobytes() == want.tobytes(), (q, got, want)


# ---------------------------------------------------------------------------
# Telescoped == per-tick in the port
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def per_tick(policy, **kw):
    return run(policy, **kw)


@pytest.mark.parametrize("chunk", [None, 17, 64])
@pytest.mark.parametrize("policy", list_policies())
def test_telescope_equals_per_tick_all_policies(policy, chunk):
    f_st, m_st = per_tick(policy)
    f_tl, os_tl = run(policy, ExecPlan(telescope=True, chunk=chunk))
    assert isinstance(os_tl, OnlineSummary)
    assert int(os_tl.n_ticks) == SMALL["horizon"]
    assert_bitwise(f_st, f_tl)
    assert_rows_match(summarize(f_st, m_st), summarize(f_tl, os_tl))


@pytest.mark.parametrize("policy", ["firstfit", "overload_migrate"])
def test_telescope_quiescent_tail(policy):
    """Horizon 200, long past the last completion, in chunks of 64: the
    idle tail telescopes (full ticks well under the horizon) without
    drifting the state or miscounting ticks."""
    f_st, m_st = per_tick(policy, horizon=200)
    f_tl, os_tl = run(policy, ExecPlan(telescope=True, chunk=64),
                      horizon=200)
    assert int(os_tl.n_ticks) == 200
    assert_bitwise(f_st, f_tl)
    assert_rows_match(summarize(f_st, m_st), summarize(f_tl, os_tl))
    cfg, net_spec, sim0, rp = small(horizon=200)
    _, _, n_full = engine.simulate_telescoped(
        sim0, stats.acc_init("cpu"), 0, cfg, get_policy(policy,
                                                        device="cpu"),
        net_spec.n_hosts, net_spec.n_nodes, 200, rp, with_stats=True)
    assert n_full < 100, n_full


@pytest.mark.parametrize("kw", [dict(delay_update_interval=0),
                                dict(delay_mode="fw")])
def test_telescope_frozen_refresh_and_fw(kw):
    f_st, m_st = per_tick("netaware", **kw)
    f_tl, os_tl = run("netaware", TELESCOPE, **kw)
    assert_bitwise(f_st, f_tl)
    assert_rows_match(summarize(f_st, m_st), summarize(f_tl, os_tl))


def test_simulate_telescoped_chunk_from_mid_run():
    """A chunk starting mid-run (t0 = 15, not a refresh tick) continues
    the per-tick run: it applies no link params, and its accumulator folds
    exactly the chunk's ticks of the per-tick series."""
    cfg, net_spec, sim0, rp = small()
    pol = get_policy("round", device="cpu")
    mid, _ = run_sim(sim0, dataclasses.replace(cfg, horizon=15), pol,
                     net_spec.n_hosts, net_spec.n_nodes, 15, params=rp)
    f_st, m_st = per_tick("round")
    final, acc, n_full = engine.simulate_telescoped(
        mid, stats.acc_init("cpu"), 15, cfg, pol, net_spec.n_hosts,
        net_spec.n_nodes, 25, rp, with_stats=True)
    assert_bitwise(f_st, final)
    assert 1 <= n_full <= 25
    assert_online_match(
        stats.online_fold(stats.online_init(), acc),
        stats.online_from_metrics(TickMetrics(*(x[15:] for x in m_st))),
        rtol=3e-6)


# ---------------------------------------------------------------------------
# The port's telescoped run against the JAX package's
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jax_small():
    import jax
    from repro.core import SimConfig as JSimConfig
    from repro.core.scenario import ScenarioSpec as JSpec
    from repro.core.scenario import build_scenario as jbuild
    cfg = JSimConfig(**SMALL)
    net_spec, sims, rp = jbuild(JSpec("baseline"), cfg, seeds=(0,), **HOSTS)
    return cfg, net_spec, jax.tree.map(lambda x: x[0], sims), rp


@pytest.mark.parametrize("policy", ["netaware", "overload_migrate"])
def test_telescoped_run_matches_jax(policy):
    import jax
    from repro.core import get_policy as jget_policy
    from repro.core import run_sim as jrun_sim
    from repro.core.types import ExecPlan as JPlan
    cfg, net_spec, sim0, rp = jax_small()
    jf, jos = jrun_sim(sim0, cfg, jget_policy(policy), net_spec.n_hosts,
                       net_spec.n_nodes, cfg.horizon, params=rp,
                       plan=JPlan(telescope=True))
    jf = jax.device_get(jf)
    tf, tos = run(policy, TELESCOPE)
    for f in ("status", "host", "n_migrations"):
        np.testing.assert_array_equal(getattr(tf.containers, f).numpy(),
                                      np.asarray(getattr(jf.containers, f)),
                                      err_msg=f)
    assert_state_close(jf, tf, RTOL, ATOL)
    assert_online_match(tos, jos, rtol=RTOL)
    assert int(tos.sum_decisions) > 0


def test_full_tick_count_matches_jax():
    """On the JAX test's quiescent-tail config (horizon 400, refresh every
    100, firstfit) the port takes as many full ticks as the JAX package,
    under half the horizon."""
    import jax
    import jax.numpy as jnp
    from repro.core import SimConfig as JSimConfig
    from repro.core import get_policy as jget_policy
    from repro.core import stats as jstats
    from repro.core.engine import simulate_telescoped as jtelescoped
    from repro.core.scenario import ScenarioSpec as JSpec
    from repro.core.scenario import build_scenario as jbuild
    kw = dict(horizon=400, delay_update_interval=100)
    jcfg = JSimConfig(**{**SMALL, **kw})
    net_spec, sims, rp = jbuild(JSpec("baseline"), jcfg, seeds=(0,), **HOSTS)
    _, _, want = jtelescoped(
        jax.tree.map(lambda x: x[0], sims), jstats.acc_init(),
        jnp.asarray(0, jnp.int32), jcfg, jget_policy("firstfit"),
        net_spec.n_hosts, net_spec.n_nodes, jcfg.horizon, rp,
        with_stats=True)
    cfg, net_spec, sim0, rp = small(**kw)
    _, acc, got = engine.simulate_telescoped(
        sim0, stats.acc_init("cpu"), 0, cfg,
        get_policy("firstfit", device="cpu"), net_spec.n_hosts,
        net_spec.n_nodes, cfg.horizon, rp, with_stats=True)
    assert got == int(want), (got, int(want))
    assert got < cfg.horizon // 2
    assert int(acc.n_ticks) == cfg.horizon


# ---------------------------------------------------------------------------
# The sweep and the weight search
# ---------------------------------------------------------------------------
SWEEP = dict(seeds=(0, 3), cfg=SimConfig(**SMALL), device="cpu", **HOSTS,
             scenarios=[ScenarioSpec("baseline"),
                        ScenarioSpec("slow_net", bw=200.0)])


@functools.lru_cache(maxsize=None)
def stacked_sweep():
    return tsweep.run_sweep(policies=["firstfit", "netaware"], **SWEEP)


@pytest.mark.parametrize("plan", [ExecPlan(telescope=True, chunk=17, slab=5),
                                  TELESCOPE])
def test_telescoped_sweep_equals_stacked(plan):
    st = stacked_sweep()
    tl = tsweep.run_sweep(policies=["firstfit", "netaware"], plan=plan,
                          **SWEEP)
    assert tl.metrics is None and isinstance(tl.summary, OnlineSummary)
    assert_bitwise(st.finals, tl.finals)
    for a, b in zip(st.summaries(), tl.summaries()):
        assert_rows_match(a, b)


def test_run_sim_vmapped_telescoped():
    cfg = SimConfig(**SMALL)
    net_spec, sims, rps = build_scenarios([ScenarioSpec("baseline")], cfg,
                                          seeds=(0, 1, 2), device="cpu",
                                          **HOSTS)
    sims1, rp1 = tree_map(lambda x: x[0], sims), tree_map(lambda x: x[0],
                                                          rps)
    pol = get_policy("jobgroup", device="cpu")
    args = (sims1, cfg, pol, net_spec.n_hosts, net_spec.n_nodes, cfg.horizon,
            rp1)
    f_st, m_st = tsweep.run_sim_vmapped(*args)
    for chunk in (13, None):
        f_tl, os_tl = tsweep.run_sim_vmapped(*args, chunk=chunk,
                                             telescope=True)
        assert_bitwise(f_st, f_tl)
        assert_online_match(os_tl, stats.online_from_metrics(m_st),
                            rtol=3e-6)


TUNE = dict(seeds=(0,), cfg=SimConfig(**{**SMALL, "horizon": 30}),
            device="cpu", scenarios=[ScenarioSpec("baseline"),
                                     ScenarioSpec("slow_net", bw=200.0)],
            **HOSTS)


@pytest.mark.parametrize("method", ["random", "cem"])
def test_tune_telescoped_scores_equal_per_tick(method):
    if method == "random":
        search = functools.partial(ttune.run_tune, n_samples=4, **TUNE)
    else:
        search = functools.partial(ttune.run_tune_cem, steps=1, batch=4,
                                   seed=2, **TUNE)
    per = search(plan=ExecPlan(chunk=11, slab=3))
    tel = [search(plan=ExecPlan(chunk=11, slab=3, telescope=True))]
    if method == "random":
        tel.append(search(plan=TELESCOPE))
    for res in tel:
        np.testing.assert_array_equal(res.weights, per.weights)
        np.testing.assert_allclose(res.scores, per.scores, rtol=3e-6)
        assert list(res.ranking()) == list(per.ranking())
    assert np.isfinite(per.scores).all()


def test_tune_grad_oracle_telescopes():
    """The hard oracle telescopes and the soft surrogate stays per tick:
    oracle scores equal to the per-tick streamed search's, surrogate
    values and the trajectory bit for bit."""
    kw = dict(steps=1, batch=2, eval_every=1, **TUNE)
    per = ttune.run_tune_grad(plan=ExecPlan(chunk=16), **kw)
    tel = ttune.run_tune_grad(plan=ExecPlan(chunk=16, telescope=True), **kw)
    np.testing.assert_allclose(tel.scores, per.scores, rtol=3e-6)
    assert tel.best_oracle == pytest.approx(per.best_oracle, rel=3e-6)
    assert np.array_equal(tel.weights, per.weights)
    assert np.array_equal(tel.surrogate, per.surrogate)
    assert tel.history == per.history


# ---------------------------------------------------------------------------
# Refusals and the command line
# ---------------------------------------------------------------------------
def test_telescope_refuses_soft_placement():
    cfg, net_spec, sim0, rp = small(soft_placement=True)
    pol = get_policy("netaware", device="cpu")
    with pytest.raises(ValueError, match="soft_placement"):
        engine.simulate_telescoped(sim0, stats.acc_init("cpu"), 0, cfg, pol,
                                   net_spec.n_hosts, net_spec.n_nodes,
                                   cfg.horizon, rp)
    with pytest.raises(ValueError, match="soft_placement"):
        run_sim(sim0, cfg, pol, net_spec.n_hosts, net_spec.n_nodes,
                cfg.horizon, params=rp, plan=TELESCOPE)


def test_csv_and_procs_with_telescope_refused(tmp_path):
    with pytest.raises(ValueError, match="drop --telescope"):
        tsim.run_one("firstfit", SimConfig(**SMALL), None, None, None,
                     csv=str(tmp_path / "m.csv"), plan=TELESCOPE)
    from repro_torch.launch import dist as tdist
    with pytest.raises(ValueError, match="telescope is not threaded"):
        tdist.run_dist_sweep(policies=["firstfit"], cfg=SimConfig(**SMALL),
                             plan=ExecPlan(telescope=True, procs=2),
                             device="cpu")
    with pytest.raises(ValueError, match="telescope is not threaded"):
        ttune.main(["--device", "cpu", "--procs", "2", "--chunk", "8",
                    "--telescope"])


def test_sweep_and_tune_clis_telescope(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tsweep.main(["--device", "cpu", "--policies", "firstfit",
                     "--hosts", "8", "--horizon", "20", "--chunk", "8",
                     "--telescope", "--out", str(tmp_path / "s.json")])
        ttune.main(["--device", "cpu", "--samples", "2", "--hosts", "8",
                    "--horizon", "20", "--telescope"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("# 5 cells (1 policies x 5 scenarios")
    assert any(x.startswith("# random: 6 cells/eval") for x in lines)
    rows = json.loads((tmp_path / "s.json").read_text())
    assert len(rows) == 5 and all(r["n_completed"] > 0 for r in rows)
