"""repro_torch.core.engine against repro.core.engine.

* per phase: from one identical mid-run state (taken from the JAX package
  and carried across with ``convert.to_torch``), each ``phase_*`` and the
  delay refresh agree with the JAX package's;
* the slice as a whole: the paper's quickstart configuration (20 hosts,
  300 containers, horizon 120) for all six policies with the 'path' delay
  refresh and one policy with 'fw' — the final state leaf by leaf
  (integer, status and placement leaves exactly, float leaves within rtol
  1e-5 / atol 1e-4), the per-tick metrics, and the ``summarize`` reports;
* the sequential placement reference equals the batched round;
* ``convert`` round-trips a state exactly.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import SimConfig as JaxSimConfig  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core import report as jrep  # noqa: E402
from repro.core import (build_paper_hosts as jax_hosts,  # noqa: E402
                        build_paper_network as jax_network,
                        get_policy as jax_policy, init_sim as jax_init,
                        paper_workload as jax_workload, run_sim as jax_run)
from repro_torch.core import (SimConfig, build_paper_hosts,  # noqa: E402
                              build_paper_network, get_policy, init_sim,
                              paper_workload, run_sim, summarize)
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core.convert import (assert_state_close,  # noqa: E402
                                      to_numpy, to_torch)
from repro_torch.core.types import ExecPlan  # noqa: E402

POLICIES = ["firstfit", "jobgroup", "netaware", "overload_migrate",
            "performance_first", "round"]
RTOL, ATOL = 1e-5, 1e-4


def jax_state(cfg):
    spec, net = jax_network(cfg)
    return spec, jax_init(jax_hosts(), jax_workload(cfg, seed=0), net,
                          seed=0)


def torch_state(cfg):
    spec, net = build_paper_network(cfg, device="cpu")
    return spec, init_sim(build_paper_hosts(device="cpu"),
                          paper_workload(cfg, seed=0, device="cpu"), net)


@functools.lru_cache(maxsize=None)
def jax_run_np(policy, delay_mode="path", horizon=120, **kw):
    cfg = JaxSimConfig(delay_mode=delay_mode, horizon=horizon, **kw)
    spec, sim0 = jax_state(cfg)
    final, metrics = jax_run(sim0, cfg, jax_policy(policy), spec.n_hosts,
                             spec.n_nodes, horizon)
    return jax.device_get(final), jax.device_get(metrics)


# ---------------------------------------------------------------------------
# Per phase, from one identical mid-run state
# ---------------------------------------------------------------------------
T_MID = 25   # arrivals still landing, flows and migrations in flight


def mid(policy):
    js = jax_run_np(policy, horizon=T_MID)[0]
    return js, to_torch(js, "cpu")


def test_mid_state_exercises_every_phase():
    js, _ = mid("overload_migrate")
    st = np.asarray(js.containers.status)
    for code in (-1, 1, 2, 3):   # unborn, running, communicating, migrating
        assert (st == code).any(), f"no container in status {code}"


@pytest.mark.parametrize("policy", POLICIES)
def test_phase_schedule_matches(policy):
    js, ts = mid(policy)
    jcfg, tcfg = JaxSimConfig(), SimConfig()
    js, _ = jeng.phase_arrive(js)
    ts, _ = teng.phase_arrive(ts)
    jout = jax.device_get(jax.jit(
        lambda s: jeng.phase_schedule(s, jcfg, jax_policy(policy)))(js))
    tout = teng.phase_schedule(ts, tcfg, get_policy(policy, device="cpu"))
    assert_state_close(jout, tout, RTOL, ATOL)


@pytest.mark.parametrize("sparse", [True, False])
def test_phase_flows_communicate_migrate_match(sparse):
    js, ts = mid("overload_migrate")
    jcfg, tcfg = JaxSimConfig(sparse_flows=sparse), SimConfig(
        sparse_flows=sparse)
    jo = jax.device_get(jeng.phase_flows(js, jcfg))
    to = teng.phase_flows(ts, tcfg)
    assert_state_close(jo[0], to[0], RTOL, ATOL)
    for a, b in zip(jo[1:], to[1:]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)
    j = jax.device_get(jeng.phase_communicate(jo[0], jcfg, jo[1]))
    t = teng.phase_communicate(to[0], tcfg, to[1])
    assert_state_close(j, t, RTOL, ATOL)
    j = jax.device_get(jeng.phase_migrate(j, jcfg, jo[2]))
    t = teng.phase_migrate(t, tcfg, to[2])
    assert_state_close(j, t, RTOL, ATOL)


@pytest.mark.parametrize("policy", ["netaware", "overload_migrate"])
def test_phase_execute_complete_cost_match(policy):
    js, ts = mid(policy)
    jcfg, tcfg = JaxSimConfig(), SimConfig()
    j = jax.device_get(jeng.phase_execute(js, jcfg))
    t = teng.phase_execute(ts, tcfg)
    assert_state_close(j, t, RTOL, ATOL)
    j = jax.device_get(jeng.phase_complete(j))
    t = teng.phase_complete(t)
    assert_state_close(j, t, RTOL, ATOL)
    j = jax.device_get(jeng.phase_cost(j))
    t = teng.phase_cost(t)
    assert_state_close(j, t, RTOL, ATOL)


def test_pick_comm_peers_match_dense_and_jax():
    js, ts = mid("jobgroup")
    ref = np.asarray(jeng.pick_comm_peers(js.containers))
    got = teng.pick_comm_peers(ts.containers).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        teng.pick_comm_peers_dense(ts.containers).numpy(), got)


@pytest.mark.parametrize("mode", ["path", "fw"])
def test_delay_refresh_matches(mode):
    js, ts = mid("netaware")
    jcfg = JaxSimConfig(delay_mode=mode)
    tcfg = SimConfig(delay_mode=mode)
    jpol, tpol = jax_policy("netaware"), get_policy("netaware", device="cpu")
    j = jax.device_get(jeng.make_refresh_fn(
        jcfg, jpol, jcfg.run_params(), 20, 26)(js.net))
    t = teng.make_refresh_fn(tcfg, tpol, tcfg.run_params("cpu"), 20,
                             26)(ts.net)
    assert_state_close(j, t, rtol=0.0, atol=0.0)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------
INT_KEYS = ("n_containers", "n_completed", "total_migrations",
            "total_arrivals", "total_decisions", "total_migration_starts",
            "flow_ticks", "peak_running", "peak_deployed", "peak_overloaded",
            "peak_queue")


@pytest.mark.parametrize("policy,mode", [(p, "path") for p in POLICIES]
                         + [("netaware", "fw")])
def test_whole_run_matches_jax(policy, mode):
    jf, jm = jax_run_np(policy, mode)
    cfg = SimConfig(delay_mode=mode)
    spec, sim0 = torch_state(cfg)
    tf, tm = run_sim(sim0, cfg, get_policy(policy, device="cpu"),
                     spec.n_hosts, spec.n_nodes, cfg.horizon)
    for f in ("status", "host", "n_migrations"):
        np.testing.assert_array_equal(getattr(tf.containers, f).numpy(),
                                      np.asarray(getattr(jf.containers, f)),
                                      err_msg=f)
    for f in ("decisions", "migrations", "rr_pointer"):
        assert int(getattr(tf.sched, f)) == int(getattr(jf.sched, f)), f
    assert_state_close(jf, tf, RTOL, ATOL)
    assert_state_close(jm, tm, RTOL, ATOL)
    rj, rt = jrep.summarize(jf, jm), summarize(tf, tm)
    assert rj.keys() == rt.keys()
    assert rt["n_completed"] == rt["n_containers"] == 300
    for k in rj:
        if k in INT_KEYS:
            assert rt[k] == rj[k], k
        else:
            np.testing.assert_allclose(rt[k], rj[k], rtol=1e-4, err_msg=k)


def test_sequential_matches_batched():
    """The sequential reference and the batched round make the same
    placements when every candidate is feasible (for the co-location
    policies too), and the sequential path matches the JAX package's."""
    kw = dict(n_jobs=10, n_tasks=40, n_containers=40, horizon=50,
              arrival_window=10.0, placements_per_tick=16,
              migrations_per_tick=2)
    for policy in ("round", "jobgroup", "netaware"):
        finals = {}
        for batched in (True, False):
            cfg = SimConfig(batched_placement=batched, **kw)
            spec, sim0 = torch_state(cfg)
            finals[batched], _ = run_sim(
                sim0, cfg, get_policy(policy, device="cpu"), spec.n_hosts,
                spec.n_nodes, cfg.horizon)
        for f in ("status", "host", "start_t", "finish_t"):
            assert torch.equal(getattr(finals[True].containers, f),
                               getattr(finals[False].containers, f)), \
                f"{policy}.{f}"
    jf, _ = jax_run_np("netaware", batched_placement=False, **kw)
    assert_state_close(jf, finals[False], RTOL, ATOL)


def test_refresh_interval_zero_freezes_the_fabric():
    """delay_update_interval == 0: one refresh at t=0, then frozen."""
    jf, _ = jax_run_np("netaware", horizon=30, delay_update_interval=0)
    cfg = SimConfig(horizon=30, delay_update_interval=0)
    spec, sim0 = torch_state(cfg)
    tf, _ = run_sim(sim0, cfg, get_policy("netaware", device="cpu"),
                    spec.n_hosts, spec.n_nodes, cfg.horizon)
    assert_state_close(jf, tf, RTOL, ATOL)


def test_convert_round_trips_exactly():
    js = jax_run_np("netaware", horizon=T_MID)[0]
    back = to_numpy(to_torch(js, "cpu"))
    assert_state_close(js, back, rtol=0.0, atol=0.0)
    for a, b in zip(jax.tree.leaves(js.containers), back.containers):
        assert np.asarray(a).dtype == b.dtype


def test_entry_points_refuse_what_this_slice_lacks():
    with pytest.raises(NotImplementedError, match="multi-process fabric"):
        ExecPlan(devices=2)
    with pytest.raises(NotImplementedError, match="telescoping"):
        ExecPlan(telescope=True)
    with pytest.raises(NotImplementedError, match="multi-process fabric"):
        ExecPlan(procs=2)
    assert ExecPlan(telescope=False, procs=1, devices=1).delay_kernel is None
    cfg = SimConfig(soft_placement=True, horizon=2)
    spec, sim0 = torch_state(cfg)
    with pytest.raises(NotImplementedError, match="autodiff"):
        run_sim(sim0, cfg, get_policy("firstfit", device="cpu"),
                spec.n_hosts, spec.n_nodes, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sim(sim0, SimConfig(horizon=2), get_policy("firstfit",
                                                       device="cpu"),
                spec.n_hosts, spec.n_nodes, 2,
                plan=ExecPlan(waterfill_kernel="on"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tnet.build_network(tnet.SpineLeafSpec())


def test_jax_network_constants_agree():
    assert tnet.INF == float(jnet.INF)
    assert tnet.LOCAL_RATE_KBPS == jnet.LOCAL_RATE_KBPS
    assert tnet.MBPS_TO_KBPS == jnet.MBPS_TO_KBPS
