"""The benchmark's inputs and its plain reference against the port's own
generators and CPU runs, at reduced sizes (CPU, no card)."""
import dataclasses

import numpy as np
import pytest
import torch

from dcbench import compare, harness, inputs, program
from dcbench.reference import sim as ref_sim

FLEET = {"hosts": 40, "host_categories": "paper-table5", "leaves": 8,
         "spines": 2, "link_bw_mbps": 1000.0, "link_loss": 0.0,
         "link_delay_ms": 0.05}
TOPOLOGY = harness.load_topology(FLEET)
CPU = torch.device("cpu")


def fabric():
    """The reference's spine-leaf fabric of ``FLEET`` on the CPU."""
    return TOPOLOGY.reference.build_net(FLEET, CPU)


def port_state(hosts, cols):
    """(the port's initial state over ``FLEET``'s fabric, n_hosts,
    n_nodes) on the CPU."""
    net, H, N = TOPOLOGY.port.build(FLEET, "cpu")
    return program.initial_state(hosts, cols, net, "cpu"), H, N


def small_sim(**over):
    sim = {"n_jobs": 40, "n_tasks": 120, "n_containers": 120,
           "duration_range": [20.0, 30.0], "cpu_req_range": [100.0, 1700.0],
           "mem_req_range": [1.0, 32.0], "gpu_req_range": [50.0, 200.0],
           "n_comms_range": [1, 5], "comm_kb_range": [100.0, 102400.0],
           "arrival_window": 10.0, "delay_update_interval": 5,
           "max_retries": 3, "max_containers_per_host": 10,
           "overload_threshold": 0.7, "idle_threshold": 0.3,
           "placements_per_tick": 64, "migrations_per_tick": 8,
           "waterfill_rounds": 8, "delay_mode": "fw",
           "stall_rate_floor": 50.0, "mig_kb_per_gb": 1024.0,
           "queue_coef": 0.5, "horizon": 24}
    sim.update(over)
    return sim


@pytest.mark.parametrize("arrival", ["paper", "trace", "bursty"])
def test_workload_draws_are_the_ports(arrival):
    p = program.port()
    sim = small_sim()
    cfg = program.sim_config(sim)
    gen = {"paper": p.scenario.paper_workload,
           "trace": p.scenario.trace_workload,
           "bursty": p.scenario.bursty_workload}[arrival]
    for seed in (0, 2**31 + 5):
        want = gen(cfg, seed=seed, device="cpu")
        got = inputs.workload(sim, arrival, seed)
        for k, v in got.items():
            np.testing.assert_array_equal(v, getattr(want, k).numpy(),
                                          err_msg=k)


@pytest.mark.parametrize("n_hosts,n_leaf", [(20, 4), (2000, 400), (23, 5)])
def test_host_tables_are_the_ports(n_hosts, n_leaf):
    p = program.port()
    want = p.datacenter.scaled_hosts(n_hosts, n_leaf, device="cpu")
    got = inputs.host_tables(TOPOLOGY.port.host_switch(
        {"hosts": n_hosts, "leaves": n_leaf}))
    for k, f in (("cap", "cap"), ("speed", "speed"), ("price", "price"),
                 ("leaf", "leaf")):
        np.testing.assert_array_equal(got[k], getattr(want, f).numpy())


def port_run(sim, policy, seed, plan=None, arrival="paper"):
    p = program.port()
    hosts = inputs.host_tables(TOPOLOGY.port.host_switch(FLEET))
    cols = inputs.workload(sim, arrival, seed)
    sim0, H, N = port_state(hosts, cols)
    cfg = program.sim_config(sim)
    final, out = p.engine.run_sim(
        sim0, cfg, p.scheduling.get_policy(policy, device="cpu"), H, N,
        sim["horizon"], plan=plan)
    summary = out if plan is not None else \
        p.stats.online_from_metrics(out)
    return (program.state_to_host(final), program.summary_to_dict(summary),
            hosts, cols)


@pytest.mark.parametrize("policy,mode", [
    ("netaware", "fw"), ("firstfit", "fw"), ("round", "path"),
    ("jobgroup", "fw"), ("overload_migrate", "path"),
    ("performance_first", "fw")])
def test_reference_is_the_ports_cpu_run(policy, mode):
    sim = small_sim(delay_mode=mode)
    state, summ, hosts, cols = port_run(sim, policy, seed=3)
    s, series, _ = ref_sim.run(hosts, cols, fabric(), sim, policy,
                               sim["horizon"], CPU)
    ref_state = compare.reference_state(s)
    for k in compare.INT_STATE + compare.FLOAT_STATE + ("h.n", "rr"):
        np.testing.assert_array_equal(state[k], ref_state[k], err_msg=k)
    got = compare.numbers(state, summ, ref_state,
                          compare.reference_summary(series))
    assert got["decisions_differ"] == 0 and got["state_gap"] == 0.0
    assert got["summary_gap"] < 1e-12


@pytest.mark.parametrize("telescope", [False, True])
def test_streamed_and_telescoped_runs_match_the_reference(telescope):
    sim = small_sim(horizon=60, delay_update_interval=20)
    p = program.port()
    plan = p.types.ExecPlan(chunk=16, telescope=telescope)
    state, summ, hosts, cols = port_run(sim, "netaware", seed=4, plan=plan)
    s, series, _ = ref_sim.run(hosts, cols, fabric(), sim, "netaware", 60,
                               CPU)
    got = compare.numbers(state, summ, compare.reference_state(s),
                          compare.reference_summary(series))
    assert got["decisions_differ"] == 0 and got["state_gap"] == 0.0
    # the streamed summary folds f32 Kahan sums, the reference f64 ones
    assert got["summary_gap"] < 1e-5


def test_scenario_overrides_reach_the_reference():
    sim = small_sim()
    p = program.port()
    hosts = inputs.host_tables(TOPOLOGY.port.host_switch(FLEET))
    cols = inputs.workload(sim, "paper", 6)
    sim0, H, N = port_state(hosts, cols)
    cfg = program.sim_config(sim)
    spec = p.scenario.ScenarioSpec("lossy_net", bw=500.0, loss=0.02)
    final, _ = p.engine.run_sim(sim0, cfg, p.scheduling.get_policy(
        "netaware", device="cpu"), H, N, sim["horizon"],
        params=spec.run_params(cfg, "cpu"))
    fields = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)
              if f.name in ("bw", "loss")}
    s, _, _ = ref_sim.run(hosts, cols, fabric(), sim, "netaware",
                          sim["horizon"], CPU, scenario=fields)
    ref_state = compare.reference_state(s)
    state = program.state_to_host(final)
    for k in compare.INT_STATE + compare.FLOAT_STATE:
        np.testing.assert_array_equal(state[k], ref_state[k], err_msg=k)


def sum4(g):
    """The reference's path sum as it stood for four-link paths alone."""
    return ((g[..., 0] + g[..., 1]) + g[..., 2]) + g[..., 3]


def spread(shape, seed):
    """Values over six decades with mixed signs: another association of
    their sums rounds otherwise."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) \
        * 10.0 ** torch.randint(-3, 3, shape, generator=g)


@pytest.mark.parametrize("shape", [(64, 4), (40, 40, 4)])
def test_the_link_sum_is_the_four_link_sum_bit_for_bit(shape):
    x = spread(shape, 0)
    assert torch.equal(ref_sim._sum_links(x), sum4(x))


def test_the_link_sum_adds_six_links_left_to_right():
    x = spread((40, 40, 6), 1)
    left = ((((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3])
            + x[..., 4]) + x[..., 5]
    right = x[..., 0] + (x[..., 1] + (x[..., 2] + (x[..., 3]
                                                   + (x[..., 4] + x[..., 5]))))
    assert torch.equal(ref_sim._sum_links(x), left)
    assert not torch.equal(left, right)      # the order is what is pinned


def padded_to_six(links):
    pad = torch.full(links.shape[:-1] + (2,), -1, dtype=links.dtype)
    return torch.cat([links, pad], dim=-1)


def test_paths_padded_to_six_links_give_the_same_network():
    """The derived tables read a path of any length: four links and two
    pads give the four-link tables bit for bit."""
    base = fabric()
    six = dict(base, path_links=padded_to_six(base["path_links"]))
    for over in ({}, {"bw": 500.0, "loss": 0.02}):
        a, b = ref_sim.network(base, **over), ref_sim.network(six, **over)
        for k in ("delay_matrix", "path_loss", "comm_cost", "link_bw_kbps"):
            assert torch.equal(a[k], b[k]), (over, k)


def test_the_waterfill_takes_paths_of_six_links():
    g = torch.Generator().manual_seed(2)
    F, E = 200, 56
    links = torch.randint(0, E, (F, 4), generator=g, dtype=torch.int32)
    links[torch.rand(F, 4, generator=g) < 0.3] = -1
    active = torch.rand(F, generator=g) < 0.7
    bw = torch.rand(E, generator=g) * 1e5 + 1e3
    tcp = torch.where(torch.rand(F, generator=g) < 0.5,
                      torch.rand(F, generator=g) * 1e4, torch.tensor(1e9))
    four = ref_sim._waterfill(links, active, bw, tcp, 8)
    six = ref_sim._waterfill(padded_to_six(links), active, bw, tcp, 8)
    for a, b in zip(four, six):
        assert torch.equal(a, b)
    assert four[0][active].gt(0).any()


def blocked_apsp(A, tile):
    """Floyd-Warshall over pivot blocks of ``tile`` nodes, the association
    of a tiled kernel such as the port's ``fw_minplus``: close the block's
    tile, relax its row and column panels by it, then the rest by the
    panels' min-plus product."""
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


@pytest.mark.parametrize("n,dyadic", [(40, False), (64, False), (150, True),
                                      (150, False), (200, False)])
def test_blocked_shortest_paths(n, dyadic):
    """Another association of the shortest paths' sums (64-node blocks)
    gives the reference's one-pivot APSP where every path sum is exact
    (dyadic weights) or one block holds the graph, and otherwise within a
    few float32 ulps of it: far inside the delay_gap limit, which the
    reference reads instead of asking for equal matrices."""
    g = torch.Generator().manual_seed(n)
    A = torch.rand(n, n, generator=g) * 2 + 0.01
    if dyadic:
        A = torch.round(A * 64) / 64
    A = torch.where(torch.rand(n, n, generator=g) < 0.2, A,
                    torch.tensor(1e9))
    A.fill_diagonal_(0.0)
    got = ref_sim._apsp(A, lowp=False)
    blocked = blocked_apsp(A, 64)
    if dyadic or n <= 64:
        assert torch.equal(got, blocked)
    else:
        torch.testing.assert_close(blocked, got, rtol=4e-7, atol=0)
    limit = 1e-4        # table6-burst's delay_gap
    assert float((blocked - got).abs().max() / got.abs().max()) < limit / 10


@pytest.mark.cuda
def test_cuda_kernel_is_within_the_delay_limit():
    """On the card: the fw_minplus kernel against the reference's APSP at
    a 2402-node graph, far inside the delay_gap limit (skips without a
    card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU "
                    "interpreter (python3 dcbench/control.py runs the "
                    "comparison at the cells' sizes on the card)")
    from repro_torch.kernels.fw_minplus import floyd_warshall
    g = torch.Generator(device="cuda").manual_seed(0)
    A = torch.rand(2402, 2402, device="cuda", generator=g) * 2 + 0.01
    A.fill_diagonal_(0.0)
    ref = ref_sim._apsp(A, lowp=False)
    gap = float((floyd_warshall(A) - ref).abs().max() / ref.abs().max())
    assert gap < 1e-6
