"""repro_torch's differentiable soft placement against repro's (the JAX
package's ``tests/test_autodiff.py`` contract), on the CPU at its small
config (10 jobs, 40 containers, 16 admits and 2 migrations a tick,
horizon 30, the paper's 20 hosts):

* ``soft_assign`` against the JAX function on random, all-infeasible and
  tied rows: ``q`` within rtol 1e-6, its gradient within rtol 1e-5;
* the flag on against the flag off in the port, bit for bit, for the six
  policies and for two temperatures;
* ``phase_schedule_soft`` from one identical state and whole soft runs:
  hard state leaves exact (a run's float metric series within rtol 1e-5 /
  atol 1e-4), the five soft terms within rtol 1e-5 of the JAX package's
  (the port's admit and migration loops stop early where the JAX scans
  add exact zeros, so the sums agree);
* ``make_grad_fn`` stacked and chunked against the JAX package's: values
  rtol 1e-5, gradients rtol 1e-4 / atol 1e-7, truncation included; the
  port's chunked gradient against its stacked one; the central-difference
  check with the JAX test's flip-free-eps recipe;
* the rejections, ``soft_num_den`` over the three summary shapes,
  ``run_tune_grad`` and ``tune --method grad``.
"""
import contextlib
import dataclasses
import functools
import io

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.core import (SimConfig, build_paper_hosts,  # noqa: E402
                              build_paper_network, get_policy, init_sim,
                              list_policies, paper_workload, run_sim, stats)
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.convert import (assert_state_close,  # noqa: E402
                                      to_torch)
from repro_torch.core.scenario import (ScenarioSpec,  # noqa: E402
                                       build_scenarios)
from repro_torch.core.scheduling import (soft_assign,  # noqa: E402
                                         weight_index)
from repro_torch.core.types import PolicyParams, TickMetrics  # noqa: E402
from repro_torch.launch import sweep as tsweep  # noqa: E402
from repro_torch.launch import tune as ttune  # noqa: E402

SMALL = dict(n_jobs=10, n_tasks=40, n_containers=40, horizon=30,
             arrival_window=10.0, placements_per_tick=16,
             migrations_per_tick=2)
SOFT_FIELDS = ("soft_comm", "soft_util", "soft_n", "soft_mig", "soft_mig_n")
SPECS = (("baseline", {}), ("slow_net", {"bw": 200.0}))
GRAD_POLICIES = ("netaware", "jobgroup")
CACHE_DIMS = [weight_index("util"), weight_index("cross_leaf")]
V_RTOL, G_RTOL, G_ATOL = 1e-5, 1e-4, 1e-7


def small_cfg(**kw):
    return SimConfig(**SMALL, **kw)


def jax_small_cfg(**kw):
    from repro.core import SimConfig as JSimConfig
    return JSimConfig(**SMALL, **kw)


def paper_sim(cfg, seed):
    spec, net = build_paper_network(cfg, device="cpu")
    return spec, init_sim(build_paper_hosts(device="cpu"),
                          paper_workload(cfg, seed=seed, device="cpu"), net)


def leaves(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for sub in tree for x in leaves(sub)]
    return [tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)]


def assert_bitwise(a, b):
    for i, (x, y) in enumerate(zip(leaves(a), leaves(b), strict=True)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), i


def assert_soft_close(jax_terms, port_terms, what=""):
    for name, a, b in zip(SOFT_FIELDS, jax_terms, port_terms, strict=True):
        b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
        np.testing.assert_allclose(b, np.asarray(a), rtol=V_RTOL,
                                   err_msg=f"{what} {name}")


# ---------------------------------------------------------------------------
# (a) the relaxation
# ---------------------------------------------------------------------------
def soft_assign_cases():
    r = np.random.default_rng(0)
    cases = []
    for tau in (0.5, 1.0, 2.0):
        row = r.uniform(0.0, 3.0, 12).astype(np.float32)
        cases.append((row, r.uniform(size=12) < 0.7, tau))
    row = r.uniform(0.0, 3.0, 12).astype(np.float32)
    cases.append((row, np.zeros(12, bool), 1.0))           # all infeasible
    tied = np.asarray([1.5, 0.25, 0.25, 2.0, 0.25, 1.0, 0.25, 3.0],
                      np.float32)                          # tied minima
    cases.append((tied, np.asarray([1, 1, 1, 0, 1, 1, 0, 1], bool), 0.7))
    return cases


@pytest.mark.parametrize("case", range(5))
def test_soft_assign_matches_jax_with_its_gradient(case):
    import jax
    import jax.numpy as jnp
    from repro.core.scheduling import soft_assign as jsoft_assign
    row, feas, tau = soft_assign_cases()[case]
    c = np.random.default_rng(case + 1).uniform(-1, 1, row.shape).astype(
        np.float32)
    jq = np.asarray(jsoft_assign(jnp.asarray(row), jnp.asarray(feas),
                                 jnp.float32(tau)))
    jg = np.asarray(jax.grad(lambda r: (jsoft_assign(
        r, jnp.asarray(feas), jnp.float32(tau)) * c).sum())(
            jnp.asarray(row)))
    t_row = torch.tensor(row, requires_grad=True)
    q = soft_assign(t_row, torch.tensor(feas), torch.tensor(tau))
    g, = torch.autograd.grad((q * torch.tensor(c)).sum(), t_row)
    np.testing.assert_allclose(q.detach().numpy(), jq, rtol=1e-6, atol=0)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5, atol=0)
    assert (q.detach().numpy()[~feas] == 0.0).all()
    assert np.isfinite(g.numpy()).all()
    if feas.any():
        assert q.sum().item() == pytest.approx(1.0, rel=1e-6)
    else:
        assert (g.numpy() == 0.0).all()


# ---------------------------------------------------------------------------
# (b) the flag never changes the dynamics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", list_policies())
def test_soft_flag_never_changes_dynamics(policy):
    cfg = small_cfg()
    spec, sim0 = paper_sim(cfg, seed=3)
    pol = get_policy(policy, device="cpu")
    f_hard, m_hard = run_sim(sim0, cfg, pol, spec.n_hosts, spec.n_nodes,
                             cfg.horizon)
    f_soft, m_soft = run_sim(sim0, dataclasses.replace(
        cfg, soft_placement=True), pol, spec.n_hosts, spec.n_nodes,
        cfg.horizon)
    assert_bitwise(f_hard, f_soft)
    for name in TickMetrics._fields:
        if name not in SOFT_FIELDS:
            assert_bitwise(getattr(m_hard, name), getattr(m_soft, name))
    assert m_soft.soft_n.sum().item() > 0
    assert all((getattr(m_hard, f) == 0).all() for f in SOFT_FIELDS)


def test_tau_never_changes_dynamics():
    cfg = small_cfg(soft_placement=True)
    spec, sim0 = paper_sim(cfg, seed=5)
    pol = get_policy("netaware", device="cpu")
    outs = []
    for tau in (0.05, 5.0):
        params = cfg.run_params("cpu")._replace(tau=torch.tensor(tau))
        outs.append(run_sim(sim0, cfg, pol, spec.n_hosts, spec.n_nodes,
                            cfg.horizon, params=params))
    (f0, m0), (f1, m1) = outs
    assert_bitwise(f0, f1)
    for name in TickMetrics._fields:
        if name not in ("soft_comm", "soft_util", "soft_mig"):
            assert_bitwise(getattr(m0, name), getattr(m1, name))
    assert not np.isclose(m0.soft_comm.sum().item(),
                          m1.soft_comm.sum().item())


# ---------------------------------------------------------------------------
# (c), (d) against the JAX package: one schedule phase, whole runs
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jax_soft_run(policy, horizon):
    """The JAX package's soft run from seed 3 (its initial state, final
    state and metrics as numpy)."""
    import jax
    from repro.core import (build_paper_hosts as jhosts,
                            build_paper_network as jnetwork,
                            get_policy as jpolicy, init_sim as jinit,
                            paper_workload as jworkload, run_sim as jrun)
    cfg = jax_small_cfg(soft_placement=True)
    spec, net = jnetwork(cfg)
    sim0 = jinit(jhosts(), jworkload(cfg, seed=3), net, seed=3)
    final, metrics = jrun(sim0, cfg, jpolicy(policy), spec.n_hosts,
                          spec.n_nodes, horizon)
    return jax.device_get((sim0, final, metrics))


@pytest.mark.parametrize("policy", ["netaware", "overload_migrate",
                                    "jobgroup"])
def test_phase_schedule_soft_matches_jax(policy):
    """From the JAX state after 9 ticks (admits and migrations both live):
    hard leaves exact, the five soft terms within rtol 1e-5."""
    import jax
    from repro.core import engine as jeng
    from repro.core import get_policy as jpolicy
    js = jax_soft_run(policy, 9)[1]
    ts = to_torch(js, "cpu")
    jcfg, tcfg = jax_small_cfg(soft_placement=True), small_cfg(
        soft_placement=True)
    js, _ = jeng.phase_arrive(js)
    ts, _ = teng.phase_arrive(ts)
    jout, jsoft = jax.device_get(jax.jit(
        lambda s: jeng.phase_schedule_soft(s, jcfg, jpolicy(policy)))(js))
    tout, tsoft = teng.phase_schedule_soft(ts, tcfg,
                                           get_policy(policy, device="cpu"))
    assert_state_close(jout, tout, rtol=0.0, atol=0.0)
    assert_soft_close(jsoft, tsoft, policy)
    assert tsoft[2].item() > 0
    if policy != "jobgroup":
        assert tsoft[4].item() > 0


@pytest.mark.parametrize("policy", list_policies())
def test_soft_run_matches_jax(policy):
    sim0, jfinal, jm = jax_soft_run(policy, SMALL["horizon"])
    cfg = small_cfg(soft_placement=True)
    spec, _ = build_paper_network(cfg, device="cpu")
    tfinal, tm = run_sim(to_torch(sim0, "cpu"), cfg,
                         get_policy(policy, device="cpu"), spec.n_hosts,
                         spec.n_nodes, cfg.horizon)
    assert_state_close(jfinal, tfinal, rtol=0.0, atol=0.0)
    # the hard metrics: integers exactly, the float series (variance, mean
    # utilization, flow rate: reductions in another order) within the
    # whole-run tolerances of tests/test_torch_engine.py
    hard = [f for f in TickMetrics._fields if f not in SOFT_FIELDS]
    assert_state_close(TickMetrics(*(getattr(jm, f) if f in hard else 0
                                     for f in TickMetrics._fields)),
                       TickMetrics(*(getattr(tm, f) if f in hard else 0
                                     for f in TickMetrics._fields)),
                       rtol=1e-5, atol=1e-4)
    assert_soft_close([getattr(jm, f) for f in SOFT_FIELDS],
                      [getattr(tm, f) for f in SOFT_FIELDS], policy)


# ---------------------------------------------------------------------------
# (e), (f) the differentiated sweep, stacked and chunked
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def grad_setup():
    cfg = small_cfg(soft_placement=True)
    net_spec, sims, rps = build_scenarios(
        [ScenarioSpec(n, **kw) for n, kw in SPECS], cfg, seeds=(0,),
        device="cpu")
    W = np.stack([get_policy(p, device="cpu").weights.numpy()
                  for p in GRAD_POLICIES])
    return cfg, net_spec, sims, rps, W


@functools.lru_cache(maxsize=None)
def jax_grads(chunk):
    """The JAX package's make_grad_fn on the same grid: (values [P],
    gradients [P, W])."""
    import jax.numpy as jnp
    from repro.core import get_policy as jpolicy
    from repro.core.scenario import ScenarioSpec as JSpec
    from repro.core.scenario import build_scenarios as jbuild
    from repro.core.types import PolicyParams as JPolicyParams
    from repro.launch.sweep import make_grad_fn as jmake_grad_fn
    cfg = jax_small_cfg(soft_placement=True)
    net_spec, sims, rps = jbuild([JSpec(n, **kw) for n, kw in SPECS], cfg,
                                 seeds=(0,))
    W = np.stack([np.asarray(jpolicy(p).weights) for p in GRAD_POLICIES])
    fn = jmake_grad_fn(cfg, net_spec.n_hosts, net_spec.n_nodes, cfg.horizon,
                       chunk=chunk)
    v, g = fn(sims, JPolicyParams(weights=jnp.asarray(W)), rps)
    return np.asarray(v), np.asarray(g)


@functools.lru_cache(maxsize=None)
def port_grads(chunk):
    cfg = small_cfg(soft_placement=True)
    net_spec, sims, rps = build_scenarios(
        [ScenarioSpec(n, **kw) for n, kw in SPECS], cfg, seeds=(0,),
        device="cpu")
    pols = tsweep.stack_policies(GRAD_POLICIES, device="cpu")
    fn = tsweep.make_grad_fn(cfg, net_spec.n_hosts, net_spec.n_nodes,
                             cfg.horizon, chunk=chunk)
    v, g = fn(sims, pols, rps)
    assert v.dtype == g.dtype == torch.float32
    assert v.shape == (2,) and g.shape == (2, len(pols.weights[0]))
    return v.numpy(), g.numpy()


@pytest.mark.parametrize("chunk", [None, 8])
def test_grad_fn_matches_jax(chunk):
    """Stacked, and chunked at 8 (boundaries inside the admit window, a
    ragged tail): values rtol 1e-5, gradients rtol 1e-4 / atol 1e-7 on
    every component, the truncated ones included."""
    tv, tg = port_grads(chunk)
    jv, jg = jax_grads(chunk)
    np.testing.assert_allclose(tv, jv, rtol=V_RTOL)
    np.testing.assert_allclose(tg, jg, rtol=G_RTOL, atol=G_ATOL)
    assert np.abs(tg).max() > 1e-3


def test_chunked_grad_matches_stacked():
    """Chunk 10 (boundaries past the 10-tick admit window): every component
    the stacked gradient's; chunk 8: every one but the two weights the
    delay refresh carries through ``comm_cost``, and those truncated."""
    sv, sg = port_grads(None)
    for chunk in (10, 8):
        cv, cg = port_grads(chunk)
        np.testing.assert_allclose(cv, sv, rtol=V_RTOL)
        exact = np.ones(sg.shape[1], bool)
        if chunk == 8:
            exact[CACHE_DIMS] = False
            assert not np.allclose(cg[:, CACHE_DIMS], sg[:, CACHE_DIMS],
                                   rtol=G_RTOL, atol=G_ATOL)
        np.testing.assert_allclose(cg[:, exact], sg[:, exact], rtol=G_RTOL,
                                   atol=G_ATOL)
        assert np.isfinite(cg).all()


# ---------------------------------------------------------------------------
# (g) central differences
# ---------------------------------------------------------------------------
def test_grad_matches_central_differences(grad_setup):
    """The JAX test's recipe: random offsets on four row weights take the
    base point off the built-ins' tie boundaries, and eps shrinks until
    w, w + eps d and w - eps d give the same final states (no decision
    flipped); the direction stays off util/cross_leaf, which feed the
    continuous ``comm_cost`` refresh."""
    cfg, net_spec, sims, rps, _ = grad_setup
    gfn = tsweep.make_grad_fn(cfg, net_spec.n_hosts, net_spec.n_nodes,
                              cfg.horizon, objective="soft_blend")
    swp = tsweep.make_sweep_fn(cfg, net_spec.n_hosts, net_spec.n_nodes,
                               cfg.horizon)
    dims = [weight_index(n) for n in
            ("row_comm", "row_coloc", "row_worst_fit", "row_cross_leaf")]
    rng = np.random.default_rng(11)
    w = get_policy("netaware", device="cpu").weights.numpy().copy()
    w[dims] += rng.uniform(0.05, 0.4, len(dims)).astype(np.float32)
    d = np.zeros_like(w)
    d[dims] = rng.normal(size=len(dims)).astype(np.float32)
    d /= np.linalg.norm(d)

    def same_trajectory(W):
        finals, _ = swp(sims, PolicyParams(weights=torch.tensor(W)), rps)
        return all((x[0] == x[1]).all() and (x[0] == x[2]).all()
                   for x in leaves(finals))

    for eps in (2e-2, 1e-2, 5e-3, 2e-3, 1e-3):
        W = np.stack([w, w + eps * d, w - eps * d]).astype(np.float32)
        if same_trajectory(W):
            break
    else:
        pytest.fail("no flip-free eps found for the FD probe")
    vals, grads = gfn(sims, PolicyParams(weights=torch.tensor(W)), rps)
    vals = vals.numpy().astype(np.float64)
    fd = (vals[1] - vals[2]) / (2 * eps)
    analytic = float(grads.numpy()[0] @ d)
    assert abs(analytic) > 1e-6
    np.testing.assert_allclose(analytic, fd, rtol=1e-2, atol=1e-5)


# ---------------------------------------------------------------------------
# (h) rejections and the objective over the three summary shapes
# ---------------------------------------------------------------------------
def test_grad_fn_rejects_hard_config_unknown_objective_and_sequential(
        grad_setup):
    cfg, net_spec, sims, rps, W = grad_setup
    hard = dataclasses.replace(cfg, soft_placement=False)
    with pytest.raises(ValueError, match="soft_placement"):
        tsweep.make_grad_fn(hard, net_spec.n_hosts, net_spec.n_nodes,
                            cfg.horizon)
    with pytest.raises(KeyError, match="unknown soft objective"):
        tsweep.make_grad_fn(cfg, net_spec.n_hosts, net_spec.n_nodes,
                            cfg.horizon, objective="avg_runtime")
    seq = dataclasses.replace(cfg, batched_placement=False)
    fn = tsweep.make_grad_fn(seq, net_spec.n_hosts, net_spec.n_nodes,
                             cfg.horizon)
    with pytest.raises(ValueError, match="batched_placement"):
        fn(sims, PolicyParams(weights=torch.tensor(W)), rps)
    assert set(stats.SOFT_OBJECTIVES) >= {"soft_blend", "soft_comm",
                                          "soft_util", "soft_mig_util"}
    with pytest.raises(KeyError):
        stats.soft_num_den(stats.acc_init("cpu"), "avg_runtime")
    with pytest.raises(TypeError):
        stats.soft_num_den({}, "soft_blend")


def test_soft_num_den_agrees_over_metrics_acc_and_online():
    cfg = small_cfg(soft_placement=True)
    spec, sim0 = paper_sim(cfg, seed=3)
    _, m = run_sim(sim0, cfg, get_policy("overload_migrate", device="cpu"),
                   spec.n_hosts, spec.n_nodes, cfg.horizon)
    acc = stats.acc_init("cpu")
    for t in range(cfg.horizon):
        acc = stats.acc_update(acc, TickMetrics(*(x[t] for x in m)))
    online = stats.online_fold(stats.online_init(), acc)
    for objective in stats.SOFT_OBJECTIVES:
        num, den = stats.soft_num_den(m, objective)
        assert den.item() > 0
        for other in (acc, online):
            n2, d2 = stats.soft_num_den(other, objective)
            np.testing.assert_allclose(float(n2), num.item(), rtol=1e-6)
            assert float(d2) == den.item()
        np.testing.assert_allclose(
            float(stats.soft_objective(online, objective)),
            stats.soft_objective(m, objective).item(), rtol=1e-6)


# ---------------------------------------------------------------------------
# (i), (j) the gradient search
# ---------------------------------------------------------------------------
def jax_first_surrogate_mean(scenarios, batch):
    """Step 0's surrogate mean of the JAX package's run_tune_grad: its
    make_grad_fn on the same first population at tau0 = 1."""
    import jax.numpy as jnp
    from repro.core.scenario import ScenarioSpec as JSpec
    from repro.core.scenario import build_scenarios as jbuild
    from repro.core.types import PolicyParams as JPolicyParams
    from repro.launch.sweep import make_grad_fn as jmake_grad_fn
    from repro.launch.tune import sample_weights as jsample
    cfg = jax_small_cfg(soft_placement=True)
    net_spec, sims, rps = jbuild(
        [JSpec(s.name, bw=s.bw) for s in scenarios], cfg, seeds=(0,))
    fn = jmake_grad_fn(cfg, net_spec.n_hosts, net_spec.n_nodes, cfg.horizon)
    obj, _ = fn(sims, JPolicyParams(weights=jnp.asarray(
        jsample(batch, seed=0))), rps)
    return float(np.mean(np.asarray(obj)))


def test_grad_tune_beats_random_at_equal_oracle_budget():
    """The JAX test's parameters: slow_net avg_runtime, 12 hard-simulator
    evaluations each; the descent finds better weights than 12 uniform
    draws, and its first step's surrogate is the JAX package's."""
    cfg = small_cfg()
    scen = [ScenarioSpec("slow_net", bw=200.0)]
    g = ttune.run_tune_grad(steps=6, batch=4, eval_every=3, lr=0.3, cfg=cfg,
                            scenarios=scen, seeds=(0,),
                            objective="avg_runtime", seed=0, device="cpu")
    assert g.oracle_evals == 12 and g.surrogate_evals == 28
    r = ttune.run_tune(n_samples=g.oracle_evals, cfg=cfg, scenarios=scen,
                       seeds=(0,), objective="avg_runtime", seed=0,
                       device="cpu")
    assert np.isfinite(g.best_oracle)
    assert g.best_oracle < float(r.scores[r.best])
    assert g.surrogate is not None and g.surrogate.shape == (4,)
    taus = [h["tau"] for h in g.history]
    assert taus == sorted(taus, reverse=True) and len(taus) == 6
    assert g.best_oracle_weights is not None
    assert g.method == "grad"
    np.testing.assert_allclose(g.history[0]["surrogate_mean"],
                               jax_first_surrogate_mean(scen, 4),
                               rtol=V_RTOL)


def test_tune_grad_cli_runs_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ttune.main(["--device", "cpu", "--method", "grad", "--steps", "1",
                    "--batch", "2", "--horizon", "10", "--hosts", "8"])
    text = out.getvalue()
    assert "# grad: 6 cells/eval" in text
    assert "after 4 oracle + 4 surrogate evals" in text
    assert "tau annealed 1 -> 1 (soft_blend surrogate)" in text
