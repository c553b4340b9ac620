"""repro_torch streaming (chunked) runs: against the port's stacked runs and
against repro.core's streaming path.

* ``stats.acc_update`` over a random 500-tick series and ``online_fold`` /
  ``online_merge`` on the same inputs as ``repro.core.stats``: integer
  fields exactly, f32 and f64 fields bit for bit;
* chunked == stacked in the port for all six policies at chunk sizes 7,
  13, 40 and 64 (non-dividing, equal to the horizon, larger than it), and
  for netaware with the 'fw' refresh: final state bit for bit, summary
  integer keys exactly, float keys within rtol 3e-6;
* the port's chunked run against ``repro.core.engine.run_sim`` with a
  chunk (final-state ints exactly, floats rtol 1e-5 / atol 1e-4;
  ``OnlineSummary`` ints exactly, floats rtol 1e-5);
* the chunk guard, ``sim0`` left untouched, ``online_init``'s fields not
  aliased, and ``launch.sim`` with ``--chunk`` and ``--telescope``.
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

from repro_torch.core import (  # noqa: E402
    SimConfig, get_policy, list_policies, run_sim, summarize)
from repro_torch.core import engine, stats  # noqa: E402
from repro_torch.core.convert import assert_state_close  # noqa: E402
from repro_torch.core.scenario import (  # noqa: E402
    ScenarioSpec, build_scenario)
from repro_torch.core.types import (ExecPlan, OnlineSummary,  # noqa: E402
                                    SummaryAcc, TickMetrics, tree_map)
from repro_torch.launch import sim as tsim  # noqa: E402

SMALL = dict(n_jobs=10, n_tasks=40, n_containers=40, horizon=40,
             arrival_window=10.0, placements_per_tick=16,
             migrations_per_tick=2)
HOSTS = dict(n_hosts=8, n_spine=2, n_leaf=4)
RTOL, ATOL = 1e-5, 1e-4
INT_KEYS = ("total_arrivals", "total_decisions", "total_migration_starts",
            "flow_ticks", "peak_running", "peak_deployed", "peak_overloaded",
            "peak_queue", "n_completed", "total_migrations", "n_containers")


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


def assert_rows_match(stacked, streamed, rtol=3e-6):
    assert stacked.keys() == streamed.keys()
    for k, va in stacked.items():
        vb = streamed[k]
        if k in INT_KEYS:
            assert va == vb, (k, va, vb)
        elif isinstance(va, float) and isinstance(vb, float):
            if not (np.isnan(va) and np.isnan(vb)):
                assert va == pytest.approx(vb, rel=rtol), (k, va, vb)
        else:
            assert va == vb, (k, va, vb)


def small(mode="path"):
    cfg = SimConfig(delay_mode=mode, **SMALL)
    net_spec, sims, rp = build_scenario(ScenarioSpec("baseline"), cfg,
                                        seeds=(0,), device="cpu", **HOSTS)
    return cfg, net_spec, tree_map(lambda x: x[0], sims), rp


@functools.lru_cache(maxsize=None)
def stacked_run(policy, mode="path"):
    cfg, net_spec, sim0, rp = small(mode)
    return run_sim(sim0, cfg, get_policy(policy, device="cpu"),
                   net_spec.n_hosts, net_spec.n_nodes, cfg.horizon, params=rp)


def chunked_run(policy, chunk, mode="path"):
    cfg, net_spec, sim0, rp = small(mode)
    return run_sim(sim0, cfg, get_policy(policy, device="cpu"),
                   net_spec.n_hosts, net_spec.n_nodes, cfg.horizon,
                   params=rp, plan=ExecPlan(chunk=chunk))


# ---------------------------------------------------------------------------
# The accumulator and the host fold against repro.core.stats
# ---------------------------------------------------------------------------
def random_series(T=500, seed=0):
    """A [T] TickMetrics series as numpy: counts as i32, the float series
    spread over several magnitudes (so the Kahan terms carry bits)."""
    r = np.random.default_rng(seed)
    f = lambda scale: (r.uniform(0, 1, T) * scale).astype(np.float32)
    i = lambda hi: r.integers(0, hi, T).astype(np.int32)
    return TickMetrics(
        t=np.arange(T, dtype=np.float32), n_overloaded=i(20),
        n_inactive=i(300), n_running=i(300), n_deployed=i(300),
        n_communicating=i(100), n_waiting=i(50), n_completed=i(300),
        n_migrating=i(20), new_arrivals=i(30), decisions=i(64),
        migrations=i(8), util_variance=f(0.05), mean_util=f(1.0),
        active_flows=i(600), mean_flow_rate=f(3e6), soft_comm=f(7.0),
        soft_util=f(0.9), soft_n=i(64).astype(np.float32),
        soft_mig=f(0.3), soft_mig_n=i(8).astype(np.float32))


def test_acc_update_matches_jax_bit_for_bit():
    import jax
    from repro.core import stats as jstats
    series = random_series()

    def body(acc, m):
        return jstats.acc_update(acc, m), None

    jacc, _ = jax.jit(lambda xs: jax.lax.scan(body, jstats.acc_init(),
                                              xs))(series)
    jacc = jax.device_get(jacc)
    tacc = stats.acc_init("cpu")
    for t in range(series.t.shape[0]):
        tacc = stats.acc_update(tacc, TickMetrics(
            *(torch.tensor(x[t]) for x in series)))
    assert tacc._fields == tuple(jacc._fields)
    for f in SummaryAcc._fields:
        a, b = np.asarray(getattr(jacc, f)), getattr(tacc, f).numpy()
        assert a.dtype == b.dtype, f
        assert a.tobytes() == b.tobytes(), (f, a, b)
    assert int(tacc.n_ticks) == 500


def random_summary(r, shape, empty=()):
    s = OnlineSummary(*(
        r.integers(1, 1000, shape).astype(np.int64)
        if f in ("n_ticks", "sum_active_flows", "sum_arrivals",
                 "sum_decisions", "sum_migrations") or f.startswith("peak")
        else r.uniform(0, 5, shape) for f in OnlineSummary._fields))
    for i in empty:          # all-zero cells, as online_init leaves them
        for x in s:
            x[i] = 0
    return s


def test_online_fold_and_merge_match_jax_exactly():
    from repro.core import stats as jstats
    r = np.random.default_rng(1)
    host = random_summary(r, (4,), empty=(2,))
    acc = SummaryAcc(*(
        r.integers(0, 100, 4).astype(np.int32)
        if f in stats.ACC_INT_FIELDS
        else r.uniform(0, 3, 4).astype(np.float32)
        for f in SummaryAcc._fields))
    got = stats.online_fold(host, acc)
    want = jstats.online_fold(host, acc)
    for f, a, b in zip(OnlineSummary._fields, want, got):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    # an acc of tensors folds the same, through one host copy
    tacc = SummaryAcc(*(torch.tensor(x) for x in acc))
    assert_bitwise(stats.online_fold(host, tacc), got)
    a, b = random_summary(r, (5,), empty=(0, 3)), random_summary(
        r, (5,), empty=(1, 3))
    for x, y in ((a, b), (b, a)):
        got, want = stats.online_merge(x, y), jstats.online_merge(x, y)
        for f, u, v in zip(OnlineSummary._fields, want, got):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes(), f


# ---------------------------------------------------------------------------
# Chunked == stacked in the port
# ---------------------------------------------------------------------------
CASES = [(p, "path") for p in list_policies()] + [("netaware", "fw")]


@pytest.mark.parametrize("chunk", [7, 13, 40, 64])
@pytest.mark.parametrize("policy,mode", CASES)
def test_chunked_equals_stacked(policy, mode, chunk):
    f_st, m_st = stacked_run(policy, mode)
    f_ch, os_ch = chunked_run(policy, chunk, mode)
    assert isinstance(os_ch, OnlineSummary)
    assert int(os_ch.n_ticks) == SMALL["horizon"]
    assert_bitwise(f_st, f_ch)
    assert_rows_match(summarize(f_st, m_st), summarize(f_ch, os_ch))


def test_link_params_apply_at_t0_only():
    """A chunk starting at t0 == 0 applies the run's link params, which
    rebuilds comm_cost; a chunk starting later must not, or it would wipe
    the delay matrix the refresh at tick 10 left (the mutation that
    applies them at every chunk fails test_chunked_equals_stacked)."""
    cfg, net_spec, sim0, rp = small()
    pol = get_policy("round", device="cpu")
    mid, _ = run_sim(sim0, dataclasses.replace(cfg, horizon=15), pol,
                     net_spec.n_hosts, net_spec.n_nodes, 15, params=rp)
    args = (cfg, pol, net_spec.n_hosts, net_spec.n_nodes, 0, rp)
    again, _ = engine.simulate_chunk(mid, stats.acc_init("cpu"), 0, *args)
    later, _ = engine.simulate_chunk(mid, stats.acc_init("cpu"), 15, *args)
    assert not torch.equal(again.net.comm_cost, mid.net.comm_cost)
    assert_bitwise(later, mid)


# ---------------------------------------------------------------------------
# The port's chunked run against the JAX package's
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jax_chunked(policy, chunk):
    import jax
    from repro.core import SimConfig as JSimConfig
    from repro.core import get_policy as jget_policy
    from repro.core import run_sim as jrun_sim
    from repro.core.scenario import ScenarioSpec as JSpec
    from repro.core.scenario import build_scenario as jbuild
    from repro.core.types import ExecPlan as JPlan
    cfg = JSimConfig(**SMALL)
    net_spec, sims, rp = jbuild(JSpec("baseline"), cfg, seeds=(0,), **HOSTS)
    sim0 = jax.tree.map(lambda x: x[0], sims)
    final, online = jrun_sim(sim0, cfg, jget_policy(policy), net_spec.n_hosts,
                             net_spec.n_nodes, cfg.horizon, params=rp,
                             plan=JPlan(chunk=chunk))
    return jax.device_get(final), online


@pytest.mark.parametrize("policy", ["netaware", "overload_migrate"])
def test_chunked_run_matches_jax(policy):
    jf, jos = jax_chunked(policy, 13)
    tf, tos = chunked_run(policy, 13)
    for f in ("status", "host", "n_migrations"):
        np.testing.assert_array_equal(getattr(tf.containers, f).numpy(),
                                      np.asarray(getattr(jf.containers, f)),
                                      err_msg=f)
    assert_state_close(jf, tf, RTOL, ATOL)
    for f, a, b in zip(OnlineSummary._fields, jos, tos):
        if np.issubdtype(np.asarray(a).dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, err_msg=f)
    assert int(tos.sum_decisions) > 0


# ---------------------------------------------------------------------------
# Guards and aliasing
# ---------------------------------------------------------------------------
def test_check_chunk_guard():
    assert stats.max_chunk_ticks(40) == (2**31 - 1) // 80
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        stats.check_chunk(0, 40)
    with pytest.raises(ValueError, match="overflow"):
        stats.check_chunk(stats.max_chunk_ticks(40) + 1, 40)
    stats.check_chunk(stats.max_chunk_ticks(40), 40)   # boundary OK
    with pytest.raises(ValueError, match="positive"):
        ExecPlan(chunk=0)
    with pytest.raises(ValueError, match="positive"):
        ExecPlan(slab=-1)


def test_chunked_run_leaves_sim0_untouched():
    cfg, net_spec, sim0, rp = small()
    before = tree_map(torch.clone, sim0)
    run_sim(sim0, cfg, get_policy("overload_migrate", device="cpu"),
            net_spec.n_hosts, net_spec.n_nodes, cfg.horizon, params=rp,
            plan=ExecPlan(chunk=8))
    assert_bitwise(before, sim0)


def test_online_init_fields_do_not_alias():
    s = stats.online_init((3,))
    ptrs = [x.__array_interface__["data"][0] for x in s]
    assert len(set(ptrs)) == len(ptrs)
    s.n_ticks[0] = 5
    assert all(int(x[0]) == 0 for f, x in zip(s._fields, s)
               if f != "n_ticks")
    acc = stats.acc_init("cpu")
    assert len({x.data_ptr() for x in acc}) == len(acc)


def sim_main(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tsim.main(["--device", "cpu", "--policy", "netaware", "--horizon",
                   "20", *argv])
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sim_cli_chunk_reports_the_same_keys(tmp_path):
    stacked, chunked = sim_main(), sim_main("--chunk", "16")
    telescoped = sim_main("--telescope")
    assert stacked.keys() == chunked.keys() == telescoped.keys()
    for k in INT_KEYS:
        assert stacked[k] == chunked[k] == telescoped[k], k
    weighted = sim_main("--weights", "cross_leaf=0.5,row_coloc=0.3")
    assert weighted.keys() == stacked.keys()
    with pytest.raises(ValueError, match="--csv"):
        sim_main("--chunk", "16", "--csv", str(tmp_path / "m.csv"))
    with pytest.raises(ValueError, match="drop --telescope"):
        sim_main("--telescope", "--csv", str(tmp_path / "m.csv"))
    with pytest.raises(ValueError, match="name=value"):
        tsim.parse_weights("cross_leaf")
