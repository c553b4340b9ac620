"""kernels.place_round: the admit round's candidate loop.

On the CPU: the engine's round takes the plain version; the kernel's
argument checks and its fleet-size limit; the plain version (the loop of
engine._place_batched) against the JAX package's round for the six
policies, bit for bit; ATen's split of the comm sum by fleet size.  On a
card, the kernel against the plain version run there, bit for bit in
chosen, used, slot counts and pointer (six policies and one weighting
every column, H 20 / 100 / 125 / 128 / 256 / 2000, K 1 / 17 / 64, the
count rows in device memory at K 256 and at 2000 hosts, the pointer at
-1 and mid-fleet, jobs of up to 8 containers, candidates no host takes,
no candidate); the comm column alone against ATen's sum at every H up to
300 and at sizes where ATen splits the sum across warps and blocks; a
non-finite cost where the count is 0:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_place_round.py
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import SimConfig, get_policy, scaled_hosts  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.network import SpineLeafSpec, build_network  # noqa: E402
from repro_torch.core.types import (  # noqa: E402
    F_COMM, NUM_POLICY_WEIGHTS, NUM_ROW_FEATURES, STATUS_INACTIVE,
    STATUS_RUNNING, W_ROW0, empty_containers,
)
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.place_round.place_round import (  # noqa: E402
    _card_split, comm_split, launch, max_hosts, place_round, place_round_ref,
    rows_fit, smem_bytes, threads_for)

F32 = torch.float32
POLICIES = ["firstfit", "jobgroup", "netaware", "overload_migrate",
            "performance_first", "round"]


def policy(name, device):
    """A built-in policy, or 'mixed': every row weight and the pointer's
    tracking non-zero, so every column reaches the score."""
    if name != "mixed":
        return get_policy(name, device=device)
    w = np.zeros(NUM_POLICY_WEIGHTS, np.float32)
    w[W_ROW0:W_ROW0 + NUM_ROW_FEATURES + 1] = np.random.default_rng(5) \
        .uniform(0.1, 2.0, NUM_ROW_FEATURES + 1)
    return get_policy("firstfit", weights=w, device=device)


@functools.lru_cache(maxsize=None)
def fabric(H, device):
    return build_network(SpineLeafSpec(n_spine=2, n_leaf=max(1, H // 5),
                                       n_hosts=H), device=device)


def random_state(H, C, seed, device, rr=-1, n_huge=0, schedulable=0.5,
                 full=False):
    """A mid-run state: hosts at random load (a few with every slot
    taken, or all with ``full``), jobs of 1 to 8 containers, about half
    of them deployed, the rest waiting; ``n_huge`` waiting containers ask
    for more memory than any host has.  Requests, loads, comm costs and
    link loads are not dyadic, so every op rounds."""
    r = np.random.default_rng(seed)
    hosts = scaled_hosts(H, max(1, H // 5), device=device)
    used = hosts.cap * torch.tensor(r.uniform(0, 0.8, (H, 3)), dtype=F32,
                                    device=device)
    ncont = np.full(H, 10) if full else r.integers(0, 11, H)
    hosts = hosts._replace(used=used, n_containers=torch.tensor(
        ncont, dtype=torch.int32, device=device))
    sizes = r.integers(1, 9, C)
    job = np.repeat(np.arange(C), sizes)[:C]
    waiting = r.uniform(size=C) < schedulable
    req = np.stack([r.uniform(100, 1700, C), r.uniform(1, 32, C),
                    r.uniform(50, 200, C)], 1)
    req[np.flatnonzero(waiting)[:n_huge], 1] = 1e6
    cols = dict(
        job=job, ctype=r.integers(0, 3, C),
        status=np.where(waiting, STATUS_INACTIVE, STATUS_RUNNING),
        host=np.where(waiting, -1, r.integers(0, H, C)),
        req=req, submit_t=r.uniform(0, 9, C), duration=r.uniform(20, 30, C))
    ct = empty_containers(C, device=device)
    ct = ct._replace(**{
        k: torch.tensor(v, dtype=getattr(ct, k).dtype, device=device)
        for k, v in cols.items()})
    net = fabric(H, device)
    net = net._replace(
        comm_cost=torch.tensor(r.uniform(0.05, 5, (H, H)), dtype=F32,
                               device=device),
        link_util=torch.tensor(r.uniform(0, 1, net.link_util.shape[0]),
                               dtype=F32, device=device))
    sim = engine.init_sim(hosts, ct, net)
    return sim._replace(
        t=torch.tensor(10.0, device=device),
        sched=sim.sched._replace(rr_pointer=torch.tensor(
            rr, dtype=torch.int32, device=device)))


def round_inputs(sim, cfg, pol):
    cand, valid, req_k, pcarry = engine._admit_candidates(sim, cfg, pol)
    return cand, valid, req_k, pcarry, int(valid.sum())


def bits(t):
    return t.view(torch.int32) if t.dtype == F32 else t


def assert_same_round(got, want):
    for name in ("chosen", "used", "ncont"):
        assert torch.equal(bits(getattr(got, name)),
                           bits(getattr(want, name))), name
    assert torch.equal(got.carry.rr, want.carry.rr), "rr"


# --- on the CPU -------------------------------------------------------------
def test_cpu_round_takes_the_plain_loop():
    cfg = SimConfig(placements_per_tick=16)
    sim = random_state(20, 60, 0, "cpu")
    pol = get_policy("netaware", device="cpu")
    before = LAUNCHES["place_round"]
    got, soft = engine._place_batched(sim, cfg, cfg.run_params("cpu"), pol)
    assert LAUNCHES["place_round"] == before and soft is None
    assert int(got.sched.decisions) > 0
    # the soft surrogate's round is the plain loop too, the same decisions
    on = SimConfig(placements_per_tick=16, soft_placement=True)
    got_soft, soft = engine._place_batched(sim, on, on.run_params("cpu"), pol)
    assert LAUNCHES["place_round"] == before and soft is not None
    assert torch.equal(got_soft.containers.host, got.containers.host)


@pytest.mark.parametrize("name", POLICIES)
def test_wrapper_on_the_cpu_is_the_plain_loop(name):
    sim = random_state(20, 90, 1, "cpu", rr=7)
    cfg = SimConfig(placements_per_tick=17)
    pol = get_policy(name, device="cpu")
    params = cfg.run_params("cpu")
    cand, valid, req_k, pcarry, n_valid = round_inputs(sim, cfg, pol)
    assert n_valid == 17
    before = LAUNCHES["place_round"]
    got = place_round(sim, cfg, params, pol, cand, valid, req_k, pcarry,
                      n_valid)
    assert LAUNCHES["place_round"] == before
    want = place_round_ref(sim, cfg, params, pol, cand, valid, req_k,
                           pcarry, n_valid)
    assert_same_round(got, want)
    assert got.soft is None


def launch_args(H=20, C=60, K=8):
    """The kernel's arguments from a CPU state, as ``place_round`` passes
    them."""
    sim = random_state(H, C, 2, "cpu")
    cfg = SimConfig(placements_per_tick=K)
    pol = get_policy("netaware", device="cpu")
    cand, _, req_k, pc, n_valid = round_inputs(sim, cfg, pol)
    h, ct = sim.hosts, sim.containers
    return dict(cap=h.cap, speed=h.speed, leaf=h.leaf,
                link_util=sim.net.link_util[:H], comm_cost=sim.net.comm_cost,
                used=h.used, ncont=h.n_containers, rr=pc.rr,
                counts=pc.counts.contiguous(),
                leafpeers=pc.leafpeers.contiguous(), cand=cand, job=ct.job,
                ctype=ct.ctype, req_k=req_k, weights=pol.weights,
                n_valid=n_valid, max_per_host=cfg.max_containers_per_host)


@pytest.mark.parametrize("name,change,match", [
    ("cap", lambda t: t.double(), "cap must be torch.float32"),
    ("ncont", lambda t: t.long(), "ncont must be torch.int32"),
    ("cand", lambda t: t.int(), "cand must be torch.int64"),
    ("counts", lambda t: t[:, :-1].contiguous(), "counts must have shape"),
    ("rr", lambda t: t.reshape(1), "rr must have shape"),
    ("weights", lambda t: t[:-1], "weights must have shape"),
    ("comm_cost", lambda t: t.t(), "comm_cost must be contiguous"),
    ("used", lambda t: t.t().contiguous().t(), "used must be contiguous"),
    ("job", lambda t: t, "must be a CUDA tensor")])
def test_kernel_argument_checks(name, change, match):
    args = launch_args()
    args[name] = change(args[name])
    with pytest.raises(ValueError, match=match):
        launch(**args)


def test_kernel_refuses_a_fleet_past_its_shared_memory():
    """Past ``max_hosts(K)`` the live state leaves no room in one block's
    shared memory: the launch raises before it looks at the device."""
    H = 20
    K = 15000
    assert max_hosts(K) < H < max_hosts(64)
    args = launch_args(H=H)
    args.update(cand=torch.zeros(K, dtype=torch.int64),
                counts=torch.zeros(K, H), leafpeers=torch.zeros(K, H),
                req_k=torch.ones(K, 3))
    with pytest.raises(ValueError, match="takes up to"):
        launch(**args)


@pytest.mark.parametrize("name", POLICIES)
def test_plain_loop_matches_the_jax_round(name):
    """engine._place_batched on the CPU (the plain loop) against the JAX
    package's round on the same state: decisions, loads, slot counts and
    pointer bit for bit."""
    import jax
    import jax.numpy as jnp
    from repro.core import SimConfig as JaxSimConfig
    from repro.core import engine as jeng
    from repro.core import get_policy as jax_policy
    from repro.core import types as jtypes
    from repro_torch.core.convert import to_numpy

    def to_jax(obj):
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            cls = getattr(jtypes, type(obj).__name__)
            extra = {"rng": jax.random.PRNGKey(0)} \
                if "rng" in cls._fields else {}
            return cls(**{f: to_jax(getattr(obj, f)) for f in obj._fields},
                          **extra)
        return jnp.asarray(obj)

    sim = random_state(20, 150, 3, "cpu", rr=11, n_huge=2)
    cfg = SimConfig(placements_per_tick=64)
    got, soft = engine._place_batched(sim, cfg, cfg.run_params("cpu"),
                                      get_policy(name, device="cpu"))
    assert soft is None
    jcfg = JaxSimConfig(placements_per_tick=64)
    want, _ = jax.jit(lambda s: jeng._place_batched(
        s, jcfg, jcfg.run_params(), jax_policy(name)))(to_jax(to_numpy(sim)))
    want = jax.device_get(want)
    pairs = [(got.containers.status, want.containers.status),
             (got.containers.host, want.containers.host),
             (got.hosts.used, want.hosts.used),
             (got.hosts.n_containers, want.hosts.n_containers),
             (got.sched.rr_pointer, want.sched.rr_pointer),
             (got.sched.decisions, want.sched.decisions)]
    for g, w in pairs:
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got.sched.decisions) < 64


@pytest.mark.parametrize("H,want", [
    (1, (1, 1)), (20, (1, 1)), (100, (1, 1)), (127, (1, 1)), (128, (4, 1)),
    (250, (8, 1)), (255, (1, 1)), (256, (4, 1)), (1023, (16, 1)),
    (1024, (4, 16)), (2000, (4, 32)), (8000, (4, 34))])
def test_comm_split_by_fleet_size(H, want):
    """ATen's (warps, blocks) a column of the comm sum on a 132-SM card:
    one thread below 128 hosts and at odd H up to 255, warps from there,
    blocks from 1024 (vectorised by 4) where each warp's share reaches
    256 rows."""
    assert comm_split(H, 132) == want


@pytest.mark.parametrize("H,K,fits", [(100, 64, True), (125, 64, True),
                                      (125, 256, False), (255, 109, True),
                                      (255, 110, False)])
def test_count_rows_in_shared_memory_by_size(H, K, fits):
    assert rows_fit(H, K) is fits
    assert smem_bytes(H, K, False) < 48 * 1024
    assert H <= max_hosts(K)
    assert threads_for(H) % 32 == 0 and 32 <= threads_for(H) <= 512


# --- on the card ------------------------------------------------------------
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "interpreter (chip_smoke.py runs place_round on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H", [20, 100, 125, 128, 256, 2000])
def test_cuda_kernel_matches_the_plain_loop(H):
    dev = card()
    rows_seen = 0
    for i, name in enumerate(POLICIES + ["mixed"]):
        pol = policy(name, dev)
        for K in (1, 17, 64) + ((256,) if H == 125 else ()):
            for rr in (-1, H // 2):
                sim = random_state(H, max(3 * H, 2 * K), 100 * i + K + rr,
                                   dev, rr=rr, n_huge=2)
                cfg = SimConfig(placements_per_tick=K)
                params = cfg.run_params(dev)
                cand, valid, req_k, pcarry, n_valid = round_inputs(sim, cfg,
                                                                   pol)
                rows_seen = max(rows_seen, int(
                    (pcarry.counts > 0).sum(1).max()))
                want = place_round_ref(sim, cfg, params, pol, cand,
                                       valid, req_k, pcarry, n_valid)
                before = LAUNCHES["place_round"]
                got = place_round(sim, cfg, params, pol, cand, valid,
                                  req_k, pcarry, n_valid)
                assert LAUNCHES["place_round"] == before + 1
                assert_same_round(got, want)
                assert bool((got.chosen[n_valid:] == -1).all())
    assert rows_seen >= 3   # comm sums of three and more terms were met


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["no_candidate", "all_hosts_full",
                                  "no_host_fits"])
def test_cuda_kernel_rounds_that_admit_nothing(case):
    dev = card()
    H, K = 100, 64
    sim = random_state(H, 300, 9, dev, rr=40,
                       schedulable=0.0 if case == "no_candidate" else 0.5,
                       full=case == "all_hosts_full",
                       n_huge=300 if case == "no_host_fits" else 0)
    cfg = SimConfig(placements_per_tick=K)
    pol = get_policy("round", device=dev)
    params = cfg.run_params(dev)
    cand, valid, req_k, pcarry, n_valid = round_inputs(sim, cfg, pol)
    assert (n_valid == 0) is (case == "no_candidate")
    want = place_round_ref(sim, cfg, params, pol, cand, valid, req_k,
                           pcarry, n_valid)
    got = place_round(sim, cfg, params, pol, cand, valid, req_k, pcarry,
                      n_valid)
    assert_same_round(got, want)
    assert bool((got.chosen == -1).all())
    assert torch.equal(bits(got.used), bits(sim.hosts.used))


def comm_inputs(H, K, seed, dev):
    """K candidates of distinct jobs, each count row with at least 8
    hosts holding 1 to 4 of its job's containers (distinct jobs: no admit
    changes another candidate's row), and the policy that scores by the
    comm column alone."""
    r = np.random.default_rng(seed)
    counts = np.zeros((K, H), np.float32)
    for k in range(K):
        hot = r.choice(H, size=min(H, int(r.integers(8, 17))), replace=False)
        counts[k, hot] = r.integers(1, 5, hot.size)
    leaf = np.arange(H) % max(1, H // 5)
    leafpeers = np.stack([np.bincount(leaf, row, leaf.max() + 1)[leaf]
                          for row in counts]).astype(np.float32)
    w = np.zeros(NUM_POLICY_WEIGHTS, np.float32)
    w[W_ROW0 + F_COMM] = 1.0
    t = lambda x, dt=F32: torch.tensor(x, dtype=dt, device=dev)
    cap = np.tile([[8000.0, 256.0, 800.0]], (H, 1))
    return dict(
        cap=t(cap), speed=t(r.uniform(0.5, 2, (H, 3))),
        leaf=t(leaf, torch.int32), link_util=t(r.uniform(0, 1, H)),
        comm_cost=t(r.uniform(0.05, 5, (H, H))), used=t(cap * 0.1),
        ncont=t(np.zeros(H), torch.int32), rr=t(-1, torch.int32),
        counts=t(counts), leafpeers=t(leafpeers),
        cand=t(np.arange(K), torch.int64), job=t(np.arange(K), torch.int32),
        ctype=t(np.zeros(K), torch.int32), req_k=t(np.ones((K, 3))),
        weights=t(w), n_valid=K, max_per_host=10)


def comm_column(cnt, comm_cost):
    """The plain version's comm column of one candidate
    (scheduling._row_feature_columns)."""
    total = cnt.sum()
    return (cnt[:, None] * comm_cost).sum(0) / torch.clamp(total, min=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [20, 100, 125, 128, 256, 2000])
def test_cuda_comm_column_bit_for_bit(H):
    dev = card()
    args = comm_inputs(H, 17, H, dev)
    want = torch.stack([comm_column(row, args["comm_cost"])
                        for row in args["counts"]])
    scores = torch.full((17, H), float("nan"), device=dev)
    launch(**args, scores=scores)
    assert torch.equal(bits(scores), bits(want))


@pytest.mark.cuda
def test_cuda_comm_order_at_every_fleet_size():
    """Every H up to 300, and sizes where ATen splits the sum across
    warps and blocks: the kernel's comm column equals ATen's sum bit for
    bit."""
    dev = card()
    sizes = list(range(1, 301)) + [511, 512, 1000, 1023, 1024, 2000, 2047,
                                   2048, 4096]
    splits = {_card_split(H, dev.index or 0) for H in sizes}
    assert {y for y, _ in splits} >= {1, 4, 8, 16}
    assert max(c for _, c in splits) > 1
    for H in sizes:
        args = comm_inputs(H, 4, 1000 + H, dev)
        want = torch.stack([comm_column(row, args["comm_cost"])
                            for row in args["counts"]])
        scores = torch.full((4, H), float("nan"), device=dev)
        launch(**args, scores=scores)
        assert torch.equal(bits(scores), bits(want)), H


@pytest.mark.cuda
@pytest.mark.parametrize("H", [100, 2000])
def test_cuda_non_finite_cost_where_the_count_is_zero(H):
    """An infinite cost on a row whose count is 0 makes ATen's product NaN
    (0 * inf) and the column's sum NaN: the kernel adds every row of such
    a column, so its columns and the round's decisions follow."""
    dev = card()
    args = comm_inputs(H, 4, 7, dev)
    cost = args["comm_cost"]
    zero = (args["counts"][0] == 0).nonzero().flatten()
    cost[zero[:3], torch.arange(3, device=dev) * (H // 3)] = float("inf")
    want = torch.stack([comm_column(row, cost) for row in args["counts"]])
    scores = torch.full((4, H), 0.0, device=dev)
    launch(**args, scores=scores)
    nan = torch.isnan(want)
    assert bool(nan.any()) and torch.equal(torch.isnan(scores), nan)
    assert torch.equal(bits(scores[~nan]), bits(want[~nan]))
    sim = random_state(H, 3 * H, 8, dev, rr=3)
    c = sim.net.comm_cost.clone()
    c[:: max(1, H // 7), 1] = float("inf")
    sim = sim._replace(net=sim.net._replace(comm_cost=c))
    cfg = SimConfig(placements_per_tick=64)
    pol = get_policy("netaware", device=dev)
    params = cfg.run_params(dev)
    cand, valid, req_k, pcarry, n_valid = round_inputs(sim, cfg, pol)
    before = LAUNCHES["place_round"]
    got = place_round(sim, cfg, params, pol, cand, valid, req_k, pcarry,
                      n_valid)
    assert LAUNCHES["place_round"] == before + 1
    assert_same_round(got, place_round_ref(sim, cfg, params, pol, cand,
                                           valid, req_k, pcarry, n_valid))
