"""repro_torch.core.scheduling against repro.core.scheduling from one
identical mid-run state: selection keys (ties, stable order), the feature
bank and the score rows for every candidate, and the migration decision,
for each of the six registered policies; plus the weight registry."""
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import SimConfig as JaxSimConfig  # noqa: E402
from repro.core import (build_paper_hosts as jax_hosts,  # noqa: E402
                        build_paper_network as jax_network,
                        init_sim as jax_init, paper_workload as jax_workload,
                        run_sim as jax_run)
from repro.core import engine as jeng  # noqa: E402
from repro.core import scheduling as jsch  # noqa: E402
from repro_torch.core import SimConfig  # noqa: E402
from repro_torch.core import scheduling as tsch  # noqa: E402
from repro_torch.core.convert import to_torch  # noqa: E402
from repro_torch.core.types import NUM_POLICY_WEIGHTS  # noqa: E402

POLICIES = sorted(["firstfit", "round", "performance_first", "jobgroup",
                   "netaware", "overload_migrate"])
T_MID = 12   # mid-arrival: a queue to schedule, deployed peers, congestion


@functools.lru_cache(maxsize=None)
def mid_state(policy):
    """The JAX package's state after T_MID ticks of ``policy`` and the
    next tick's arrivals (numpy): a queue waiting for the scheduler."""
    cfg = JaxSimConfig(horizon=T_MID)
    spec, net = jax_network(cfg)
    sim0 = jax_init(jax_hosts(), jax_workload(cfg, seed=0), net, seed=0)
    final, _ = jax_run(sim0, cfg, jsch.get_policy(policy), spec.n_hosts,
                       spec.n_nodes, T_MID)
    return jax.device_get(jeng.phase_arrive(final)[0])


def test_registry_matches_jax():
    assert tsch.list_policies() == POLICIES == jsch.list_policies()
    for name in POLICIES:
        np.testing.assert_array_equal(
            tsch.get_policy(name, device="cpu").weights.numpy(),
            np.asarray(jsch.get_policy(name).weights))


def test_registry_length_checks():
    with pytest.raises(ValueError, match="canonical length"):
        tsch.register("short", np.zeros(NUM_POLICY_WEIGHTS - 1))
    with pytest.raises(ValueError, match="canonical length"):
        tsch.get_policy("firstfit", np.zeros(3), device="cpu")
    with pytest.raises(KeyError):
        tsch.weight_vector(not_a_weight=1.0)
    with pytest.raises(KeyError):
        tsch.get_policy("no_such_policy", device="cpu")
    w = tsch.get_policy("netaware", {"cross_leaf": 0.5}, device="cpu")
    assert float(w.weights[1]) == 0.5
    assert "short" not in tsch.list_policies()


def test_rank_key_ties_stable_order():
    vals = np.array([3.0, 1.0, 3.0, 1.0, np.inf, 2.0, 1.0], np.float32)
    mask = np.array([1, 1, 1, 1, 0, 1, 1], bool)
    ref = np.asarray(jsch.rank_key(jnp.asarray(vals), jnp.asarray(mask)))
    got = tsch.rank_key(torch.tensor(vals), torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(got, ref)
    # ties broken by index: the three 1.0s rank 0, 1, 2 in slot order
    np.testing.assert_array_equal(got[[1, 3, 6]], [0, 1, 2])
    assert got[4] == tsch.INT_BIG


@pytest.mark.parametrize("policy", POLICIES)
def test_selection_and_placement_rows_match(policy):
    js = mid_state(policy)
    ts = to_torch(js, "cpu")
    jcfg, tcfg = JaxSimConfig(), SimConfig()
    jpol, tpol = jsch.get_policy(policy), tsch.get_policy(policy,
                                                          device="cpu")
    jpar, tpar = jcfg.run_params(), tcfg.run_params("cpu")

    jkey = np.asarray(jsch.select_key(js, jpol))
    tkey = tsch.select_key(ts, tpol)
    np.testing.assert_array_equal(tkey.numpy(), jkey)
    assert (jkey < jsch.INT_BIG).sum() >= 2, "mid state has no queue"
    np.testing.assert_array_equal(
        tsch.select_key_fifo(ts).numpy(), np.asarray(jsch.select_key_fifo(js)))

    # candidates: the K smallest keys, as the batched round takes them
    K = 16
    cand = np.argsort(jkey, kind="stable")[:K].astype(np.int32)
    jc, tc = jnp.asarray(cand), torch.tensor(cand).long()
    jcarry = jsch.init_place_carry(js, jc, jpol)
    tcarry = tsch.init_place_carry(ts, tc, tpol)
    np.testing.assert_array_equal(tcarry.counts.numpy(),
                                  np.asarray(jcarry.counts))
    np.testing.assert_array_equal(tcarry.leafpeers.numpy(),
                                  np.asarray(jcarry.leafpeers))
    used_j, used_t = js.hosts.used, ts.hosts.used
    for k in range(K):
        jf = np.asarray(jsch.placement_features(js, jcfg, jpar, jcarry, k, jc,
                                                used_j))
        tf = tsch.placement_features(ts, tcfg, tpar, tcarry, k, tc,
                                     used_t).numpy()
        np.testing.assert_allclose(tf, jf, rtol=1e-6, atol=1e-7)
        jrow = np.asarray(jsch.host_row(js, jcfg, jpar, jpol, jcarry, k, jc,
                                        used_j))
        trow = tsch.host_row(ts, tcfg, tpar, tpol, tcarry, k, tc,
                             used_t).numpy()
        np.testing.assert_allclose(trow, jrow, rtol=1e-6, atol=1e-7)
        assert np.argmin(trow) == np.argmin(jrow)
        hh = int(np.argmin(jrow))
        ok = bool(jkey[cand[k]] < jsch.INT_BIG)
        jcarry = jsch.update_place_carry(js, jpol, jcarry, k, jc,
                                         jnp.int32(hh), jnp.asarray(ok))
        tcarry = tsch.update_place_carry(ts, tpol, tcarry, k, tc,
                                         torch.tensor(hh), torch.tensor(ok))
        assert int(tcarry.rr) == int(jcarry.rr)
        np.testing.assert_array_equal(tcarry.counts.numpy(),
                                      np.asarray(jcarry.counts))


@pytest.mark.parametrize("policy", POLICIES)
def test_migrate_matches(policy):
    js = mid_state(policy)
    ts = to_torch(js, "cpu")
    jcfg, tcfg = JaxSimConfig(), SimConfig()
    jpar, tpar = jcfg.run_params(), tcfg.run_params("cpu")
    for thr in (0.3, 0.7):    # a low threshold makes every policy's source
        jp = jpar._replace(overload_threshold=jnp.float32(thr))
        tp = tpar._replace(overload_threshold=torch.tensor(thr))
        jc, jd = jsch.migrate(js, jcfg, jp, jsch.get_policy(policy))
        tc, td = tsch.migrate(ts, tcfg, tp, tsch.get_policy(policy,
                                                            device="cpu"))
        assert (int(tc), int(td)) == (int(jc), int(jd))
        src_j = jsch._overload_source(js, jcfg, jp)
        src_t = tsch._overload_source(ts, tcfg, tp)
        assert int(src_t[0]) == int(src_j[0])
        assert int(src_t[1]) == int(src_j[1])
        np.testing.assert_array_equal(src_t[3].numpy(), np.asarray(src_j[3]))
        np.testing.assert_array_equal(
            tsch.migration_features(ts, src_t[2]).numpy(),
            np.asarray(jsch.migration_features(js, src_j[2])))
