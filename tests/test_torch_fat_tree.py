"""The k-ary fat tree in repro_torch (``core.network.FatTreeSpec``): paths
of six links through the network layer and ``seg_waterfill``.

On the CPU: the path sum over P links is the old four-link sum bit for
bit at P = 4 and left to right at P = 6; spine-leaf tables padded to six
links give the same derived tables; the sparse engine against the dense
oracle over fat-tree paths; the flow counts by path length, made under
a profiler on the fat tree and not on the spine-leaf; the kernel
wrapper's widths and shared-memory sizes at P = 6; ``launch.sim
--topology fat_tree`` at k = 4, and the spine-leaf default as it was.
On a card, at the ``fattree1k-backlog`` cell's sizes (k = 16): the P = 6
kernel, both variants, bit for bit against its plain version;
``fw_minplus`` at n = 1344 against ``floyd_warshall_ref``;
``place_round`` at H = 1024 on a fat-tree comm matrix:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fat_tree.py
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import network  # noqa: E402
from repro_torch.core.network import (FatTreeSpec, SpineLeafSpec,  # noqa: E402
                                      build_network)
from repro_torch.kernels.seg_waterfill import seg_waterfill_ref  # noqa: E402
from repro_torch.kernels.seg_waterfill.seg_waterfill import (  # noqa: E402
    SMEM_LIMIT, _launch_global, _launch_smem, smem_bytes, variant)
from repro_torch.launch import sim as launch_sim  # noqa: E402

F32 = torch.float32


def spread(shape, seed):
    """Values over six decades with mixed signs: another association of
    their sums rounds otherwise."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) \
        * 10.0 ** torch.randint(-3, 3, shape, generator=g)


@pytest.mark.parametrize("shape", [(64, 4), (40, 40, 4)])
def test_the_path_sum_at_four_links_is_the_old_sum4(shape):
    x = spread(shape, 0)
    old = ((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]
    assert torch.equal(network._sum(x), old)


def test_the_path_sum_adds_six_links_left_to_right():
    x = spread((40, 40, 6), 1)
    left = ((((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3])
            + x[..., 4]) + x[..., 5]
    right = x[..., 0] + (x[..., 1] + (x[..., 2] + (x[..., 3]
                                                   + (x[..., 4] + x[..., 5]))))
    assert torch.equal(network._sum(x), left)
    assert not torch.equal(left, right)      # the order is what is pinned


def test_spine_leaf_paths_padded_to_six_links_give_the_same_tables():
    net = build_network(SpineLeafSpec(n_spine=5, n_leaf=20, n_hosts=100),
                        device="cpu")
    g = torch.Generator().manual_seed(3)
    net = net._replace(link_util=torch.rand(net.link_util.shape, generator=g),
                       link_loss=torch.rand(net.link_loss.shape,
                                            generator=g) * 0.02)
    pad = torch.full((100, 100, 2), -1, dtype=net.path_links.dtype)
    six = net._replace(path_links=torch.cat([net.path_links, pad], -1))
    d = network.congested_link_delay(net)
    for f in (lambda n: network.path_delay_matrix(d, n.path_links),
              lambda n: network.path_loss_matrix(n.link_loss, n.path_links),
              network.path_util_matrix, network.pairwise_comm_cost):
        assert torch.equal(f(net), f(six))


def fat_tree_flows(net, H, F, seed, p_active=0.6):
    """F flows between random host pairs (some a host to itself): src, dst,
    active flags, their [F, 6] link ids (-1 pads and for inactive flows),
    capacities and Mathis caps."""
    r = np.random.default_rng(seed)
    src = torch.tensor(r.integers(0, H, F))
    dst = torch.tensor(np.where(r.uniform(size=F) < 0.05, src.numpy(),
                                r.integers(0, H, F)))
    active = torch.tensor(r.uniform(size=F) < p_active)
    links = torch.where(active[:, None], net.path_links[src, dst], -1)
    bw = torch.tensor(r.uniform(1e3, 1e5, net.link_bw.shape[0]), dtype=F32)
    tcp = torch.tensor(np.where(r.uniform(size=F) < 0.3,
                                r.uniform(10, 1e4, F), network.INF),
                       dtype=F32)
    return src, dst, active, links, bw, tcp


@pytest.mark.parametrize("k", [4, 6])
def test_dense_oracle_matches_sparse_over_six_link_paths(k):
    spec = FatTreeSpec(k=k)
    net = build_network(spec, device="cpu")
    for seed in range(4):
        src, dst, active, links, _, _ = fat_tree_flows(
            net, spec.n_hosts, 4 * spec.n_hosts, seed)
        assert int((links >= 0).sum(1).max()) == 6
        r_s, u_s = network.flow_rates(net, src, dst, active, sparse=True)
        r_d, u_d = network.flow_rates(net, src, dst, active, sparse=False)
        torch.testing.assert_close(r_s, r_d, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(u_s, u_d, rtol=1e-4, atol=1e-5)
        # the plain kernel version is the sparse engine's chain
        tcp = network.mathis_cap_sparse(net.delay_matrix, net.path_loss,
                                        src, dst)
        rates, load = seg_waterfill_ref(links, active, net.link_bw_kbps, tcp)
        assert torch.equal(rates, r_s)


@pytest.mark.parametrize("slots,want", [
    ([9, 9, 7, 7, 5, 5], {"flows_2link": 2, "flows_4link": 2,
                          "flows_6link": 5}),
    ([4, 4, 1, 1], {"flows_2link": 3, "flows_4link": 1}),
    ([0, 0, 0, 0], {})])
def test_flows_by_length(slots, want):
    assert network.flows_by_length(slots) == want


@pytest.mark.parametrize("spec,want", [
    (SpineLeafSpec(n_spine=2, n_leaf=4, n_hosts=20), {}),
    (FatTreeSpec(k=4), None)])
def test_flows_are_counted_by_length_only_past_four_links(spec, want):
    """Profiled, a spine-leaf flow allocation makes no device count (its
    traced tick launches what it did before); a fat-tree one counts the
    active flows on links by path length."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import trace
    net = build_network(spec, device="cpu")
    src, dst, active, links, _, _ = fat_tree_flows(net, spec.n_hosts, 200, 5)
    with profile(activities=[ProfilerActivity.CPU]):
        network.flow_rates(net, src, dst, active)
        network.flow_rates(net, src, dst, active)
        got = {k: v for k, v in trace.snapshot().totals.items()
               if k.startswith("flows_")}
    if want is None:
        n = (links >= 0).sum(1)
        want = {f"flows_{L}link": 2 * int((n == L).sum()) for L in (2, 4, 6)}
        assert want["flows_6link"] > 0
    assert got == want


def test_waterfill_sizes_count_the_path_width():
    assert smem_bytes(100, 50) == smem_bytes(100, 50, 4) == 13 * 100 \
        + 17 * 50 + 132
    assert smem_bytes(100, 50, 6) == 17 * 100 + 17 * 50 + 132
    # the fattree1k-backlog cell's F = 30,720 over E = 3072: the global
    # variant; the largest F the one-launch variant holds there at P = 6
    assert variant(30720, 3072, 6) == "global"
    f_max = (SMEM_LIMIT - 132 - 17 * 3072) // 17
    assert variant(f_max, 3072, 6) == "smem"
    assert variant(f_max + 1, 3072, 6) == "global"
    assert variant(f_max + 1, 3072, 4) == "smem"


@pytest.mark.parametrize("launch", [_launch_smem, _launch_global])
def test_the_kernel_refuses_a_width_it_is_not_built_for(launch):
    links = torch.zeros((8, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="P in"):
        launch(links, torch.ones(8, dtype=torch.bool), torch.ones(4),
               torch.ones(8))


def run_cli(args, tmp_path, name):
    out = tmp_path / f"{name}.json"
    launch_sim.main(args + ["--device", "cpu", "--policy", "netaware",
                            "--out", str(out)])
    rows = json.loads(out.read_text())
    for r in rows:
        r.pop("wall_s")
    return rows


def test_the_cli_runs_a_fat_tree(tmp_path):
    small = ["--horizon", "12", "--containers", "48", "--delay-mode", "fw"]
    row, = run_cli(small + ["--topology", "fat_tree", "--k", "4"], tmp_path,
                   "fat")
    assert row["n_containers"] == 48 and row["total_decisions"] > 0
    assert row["flow_ticks"] > 0
    # spine-leaf stays the default, its output as named
    plain = run_cli(small, tmp_path, "plain")
    named = run_cli(small + ["--topology", "spine_leaf"], tmp_path, "named")
    assert plain == named and plain != [row]
    with pytest.raises(SystemExit):
        launch_sim.main(["--topology", "fat_tree", "--k", "4", "--hosts",
                         "20", "--device", "cpu"])


# --- on the card ------------------------------------------------------------
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "interpreter (the fattree1k-backlog cell runs them at "
                    "these sizes on the card)")
    return torch.device("cuda")


K16 = FatTreeSpec(k=16)


@pytest.mark.cuda
def test_cuda_waterfill_at_six_links_both_variants():
    dev = card()
    net = build_network(K16, device="cpu")
    H, E = K16.n_hosts, K16.n_links
    f_max = (SMEM_LIMIT - 132 - 17 * E) // 17
    for F, seed, launches in ((30720, 0, (_launch_global,)),
                              (30720, 1, (_launch_global,)),
                              (f_max, 2, (_launch_smem, _launch_global)),
                              (1000, 3, (_launch_smem, _launch_global))):
        _, _, active, links, bw, tcp = fat_tree_flows(net, H, F, seed)
        if seed == 1:   # a hot link: every path of 4 or 6 links crosses 2H
            links[:, 2] = torch.where(links[:, 2] >= 0, 2 * H, -1)
        flows = (links, active, bw, tcp)
        # the plain version on the CPU adds each link's slots in slot order
        want = seg_waterfill_ref(*flows)
        for launch in launches:
            got = launch(*(t.to(dev) for t in flows))
            assert torch.equal(got[0].cpu(), want[0]), (F, launch)
            assert torch.equal(got[1].cpu(), want[1]), (F, launch)


@pytest.mark.cuda
@pytest.mark.parametrize("dyadic", [True, False])
def test_cuda_fw_minplus_over_the_k16_fabric(dyadic):
    from repro_torch.kernels.fw_minplus import floyd_warshall
    dev = card()
    net = build_network(K16, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(dyadic))
    util = torch.rand(net.link_util.shape, generator=g, device=dev)
    d = network.congested_link_delay(net._replace(link_util=util))
    if dyadic:   # multiples of 1/64: every path sum exact in f32
        d = torch.round(d * 64) / 64
    A = network.adjacency_from_links(net, d, K16.n_nodes)
    assert A.shape == (1344, 1344)
    got, want = floyd_warshall(A), network.floyd_warshall_ref(A)
    if dyadic:
        assert torch.equal(got, want)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-6


@pytest.mark.cuda
def test_cuda_place_round_on_a_k16_comm_matrix():
    import test_torch_place_round as pr
    from repro_torch.core import SimConfig
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.place_round.place_round import (
        place_round, place_round_ref)
    dev = card()
    H = K16.n_hosts
    net = build_network(K16, device=dev)
    for i, name in enumerate(pr.POLICIES + ["mixed"]):
        pol = pr.policy(name, dev)
        sim = pr.random_state(H, 3 * H, 7 + i, dev, rr=H // 3, n_huge=2)
        g = torch.Generator(device=dev).manual_seed(i)
        fabric = net._replace(link_util=torch.rand(
            net.link_util.shape, generator=g, device=dev))
        fabric = fabric._replace(comm_cost=network.pairwise_comm_cost(fabric))
        sim = sim._replace(
            net=fabric,
            hosts=sim.hosts._replace(leaf=torch.arange(
                H, dtype=torch.int32, device=dev) % K16.n_edge))
        cfg = SimConfig(placements_per_tick=64)
        params = cfg.run_params(dev)
        cand, valid, req_k, pcarry, n_valid = pr.round_inputs(sim, cfg, pol)
        want = place_round_ref(sim, cfg, params, pol, cand, valid, req_k,
                               pcarry, n_valid)
        before = LAUNCHES["place_round"]
        got = place_round(sim, cfg, params, pol, cand, valid, req_k, pcarry,
                          n_valid)
        assert LAUNCHES["place_round"] == before + 1
        pr.assert_same_round(got, want)
