"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's kernels run as its own tests run them — Pallas in interpret
mode — and against its jnp references; kernel selection; and, on a card,
each CUDA kernel against its plain version.  JAX is imported inside the
tests that use it, so the ``cuda``-marked test also runs where there is a
card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py

Contracts: seg_waterfill rates bit for bit, load within rtol 2e-6;
fw_minplus bit for bit on dyadic weights, rtol 1e-5 otherwise; the plain
path's segment sums on the card bit for bit with the CPU's.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.kernels import LAUNCHES, resolve_kernel  # noqa: E402
from repro_torch.kernels.fw_minplus import (floyd_warshall,  # noqa: E402
                                            floyd_warshall_ref)
from repro_torch.kernels.fw_minplus.fw_minplus import (  # noqa: E402
    PAD, TILE, cuda_launches, pad_adjacency)
from repro_torch.kernels.seg_waterfill import (seg_waterfill,  # noqa: E402
                                               seg_waterfill_ref)
from repro_torch.kernels.seg_waterfill.seg_waterfill import (  # noqa: E402
    SMEM_LIMIT, _launch_global, _launch_smem, smem_bytes, variant)

INF = 1e9


def random_flows(F, E, seed):
    r = np.random.default_rng(seed)
    links = r.integers(0, E, (F, 4)).astype(np.int32)
    links[np.arange(4)[None, :] >= r.integers(0, 5, F)[:, None]] = -1
    links[r.uniform(size=F) < 0.1] = -1          # local (no-link) flows
    active = r.uniform(size=F) < 0.8
    bw = r.uniform(1e3, 1e5, E).astype(np.float32)
    tcp = np.where(r.uniform(size=F) < 0.3, r.uniform(10, 1e4, F),
                   INF).astype(np.float32)
    return links, active, bw, tcp


def hot_link_flows(F, E, seed):
    """F flows over E links in which every active flow crosses link 0:
    that link's list is about 0.8 F long, far above the warp-walk
    threshold."""
    r = np.random.default_rng(seed)
    links = r.integers(1, E, (F, 4)).astype(np.int32)
    links[np.arange(4)[None, :] >= r.integers(1, 5, F)[:, None]] = -1
    links[:, 0] = 0
    active = r.uniform(size=F) < 0.8
    links[~active] = -1
    bw = r.uniform(1e5, 1e6, E).astype(np.float32)
    tcp = np.where(r.uniform(size=F) < 0.3, r.uniform(10, 1e4, F),
                   INF).astype(np.float32)
    return links, active, bw, tcp


def random_adjacency(n, seed, dyadic):
    r = np.random.default_rng(seed)
    if dyadic:   # multiples of 1/64: path sums are exact in f32
        A = (r.integers(8, 512, (n, n)) / 64.0).astype(np.float32)
    else:
        A = r.uniform(0.1, 10, (n, n)).astype(np.float32)
    A[r.uniform(size=(n, n)) < 0.5] = INF
    A = np.minimum(A, A.T)
    np.fill_diagonal(A, 0.0)
    return A


def disconnected_adjacency(n, seed):
    """A dyadic graph of two components (nodes drawn at random into
    either) and the mask of the pairs across them, unreachable."""
    A = random_adjacency(n, seed, True)
    comp = np.random.default_rng(seed).integers(0, 2, n)
    apart = comp[:, None] != comp[None, :]
    A[apart] = INF
    return A, apart


# n below, at and above one and two tiles of the kernel
EDGE_NS = (TILE - 1, TILE, TILE + 1, 2 * TILE - 1, 2 * TILE, 2 * TILE + 1)


# --- seg_waterfill ----------------------------------------------------------
@pytest.mark.parametrize("F,E,seed,n_rounds", [(33, 16, 1, 8), (64, 9, 3, 8),
                                               (50, 6, 7, 1)])
def test_waterfill_matches_jax_interpret_and_ref(F, E, seed, n_rounds):
    import jax.numpy as jnp
    from repro.kernels.seg_waterfill import ops as jwf_ops
    from repro.kernels.seg_waterfill.ref import seg_waterfill_ref as jwf_ref
    links, active, bw, tcp = random_flows(F, E, seed)
    j_in = [jnp.asarray(x) for x in (links, active, bw, tcp)]
    r_ref, l_ref = jwf_ref(*j_in, n_rounds=n_rounds)
    r_int, l_int = jwf_ops.seg_waterfill(*j_in, n_rounds=n_rounds,
                                         interpret=True)
    r_t, l_t = seg_waterfill(*(torch.tensor(x) for x in
                               (links, active, bw, tcp)), n_rounds=n_rounds)
    for r_j, l_j in ((r_ref, l_ref), (r_int, l_int)):
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
        np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=2e-6,
                                   atol=1e-3)


def test_waterfill_wrapper_on_cpu_is_the_plain_version():
    args = [torch.tensor(x) for x in random_flows(40, 12, 11)]
    before = LAUNCHES["seg_waterfill"]
    r_w, l_w = seg_waterfill(*args)
    r_p, l_p = seg_waterfill_ref(*args)
    assert LAUNCHES["seg_waterfill"] == before   # no kernel on the CPU
    assert torch.equal(r_w, r_p) and torch.equal(l_w, l_p)


@pytest.mark.parametrize("F,E,want", [
    (600, 28, "smem"), (12000, 2800, "smem"),        # paper, real size
    (14208, 2800, "smem"), (14209, 2800, "global"),  # 13F + 17E + 132 bytes
    (0, 13665, "smem"), (0, 13666, "global"),
    (16383, 16, "smem"), (16384, 16, "global"),      # 4F slots fit u16
    (65535, 1, "global"), (65536, 1, "global"), (200000, 2800, "global")])
def test_waterfill_variant_by_size(F, E, want):
    assert variant(F, E) == want
    assert (smem_bytes(F, E) <= SMEM_LIMIT) >= (want == "smem")


@pytest.mark.parametrize("launch", [_launch_smem, _launch_global])
def test_waterfill_variants_take_cuda_tensors_only(launch):
    # a variant launched by name has no plain-version fallback: on CPU
    # tensors it raises instead of computing
    args = [torch.tensor(x) for x in random_flows(16, 5, 4)]
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        launch(*args)


# --- fw_minplus -------------------------------------------------------------
@pytest.mark.parametrize("n,dyadic", [(37, True), (37, False), (8, True),
                                      (30, False), (TILE - 1, True),
                                      (TILE, False), (TILE + 1, True),
                                      (2 * TILE + 1, True),
                                      (2 * TILE + 1, False)])
def test_fw_matches_jax_interpret_and_ref(n, dyadic):
    import jax.numpy as jnp
    from repro.core import network as jnet
    from repro.kernels.fw_minplus import ops as jfw_ops
    A = random_adjacency(n, n, dyadic)
    D_ref = np.asarray(jnet.floyd_warshall_ref(jnp.asarray(A)))
    D_t = floyd_warshall(torch.tensor(A)).numpy()
    # the plain versions follow the same pivot order: bit for bit
    np.testing.assert_array_equal(D_t, D_ref)
    # the TPU kernel, interpreted, blocked at 16 and at the CUDA kernel's
    # tile edge
    for bs in (16, TILE):
        D_int = np.asarray(jfw_ops.floyd_warshall(jnp.asarray(A), bs=bs,
                                                  interpret=True))
        if dyadic:
            np.testing.assert_array_equal(D_t, D_int)
        else:
            np.testing.assert_allclose(D_t, D_int, rtol=1e-5, atol=1e-4)
    assert torch.equal(floyd_warshall_ref(torch.tensor(A)),
                       torch.tensor(D_t))


@pytest.mark.parametrize("n", (1, 5) + EDGE_NS)
def test_pad_adjacency_at_the_kernel_tile(n):
    A = torch.tensor(random_adjacency(n, n, False))
    D = pad_adjacency(A)
    n_pad = -(-n // TILE) * TILE
    assert D.shape == (n_pad, n_pad) and n_pad % TILE == 0
    assert torch.equal(D[:n, :n], A)
    pad = torch.ones((n_pad, n_pad), dtype=torch.bool)
    pad[:n, :n] = False
    diag = torch.eye(n_pad, dtype=torch.bool)
    assert bool((D[pad & ~diag] == PAD).all())
    assert bool((D[pad & diag] == 0.0).all())
    # the kernel's launches: two per pivot block, one for a single tile
    assert cuda_launches(n) == (1 if n_pad == TILE else 2 * n_pad // TILE)


def test_fw_disconnected_stays_inf():
    A = np.full((6, 6), INF, np.float32)
    np.fill_diagonal(A, 0.0)
    A[0, 1] = A[1, 0] = 1.5
    D = floyd_warshall(torch.tensor(A)).numpy()
    assert D[0, 1] == 1.5 and D[0, 2] == INF and D[2, 2] == 0.0
    A, apart = disconnected_adjacency(2 * TILE + 1, 6)
    D = floyd_warshall(torch.tensor(A)).numpy()
    assert bool((D[apart] == INF).all()) and bool((D[~apart] < INF).any())


# --- kernel selection -------------------------------------------------------
def test_resolve_kernel_flags_on_cpu():
    assert resolve_kernel("auto", "cpu") is False
    assert resolve_kernel("off", "cpu") is False
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_kernel("on", "cpu")
    with pytest.raises(ValueError):
        resolve_kernel("maybe", "cpu")
    assert resolve_kernel("auto", "cuda") is True
    assert resolve_kernel("on", "cuda") is True
    assert resolve_kernel("off", "cuda") is False


# --- on the card ------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "interpreter (chip_smoke.py runs this check on the card)")
    dev = torch.device("cuda")
    # the paper's F = 600 over its E = 28 links; a hot link (every active
    # flow on link 0, a list far above the warp-walk threshold); shapes
    # just below and above each bound of variant(F, E); the variant the
    # wrapper picks and the global one on the same input
    cases = [random_flows(F, E, seed)
             for F, E, seed in [(8, 5, 0), (600, 140, 1), (600, 28, 2),
                                (14208, 2800, 3), (14209, 2800, 4),
                                (16383, 16, 5), (16384, 16, 6)]]
    cases.append(hot_link_flows(12000, 2800, seed=5))
    # the plain version on the CPU, where index_add_ adds each link's slots
    # in slot order (on the card it need not)
    for flows in cases:
        args = [torch.as_tensor(x) for x in flows]
        r_p, l_p = seg_waterfill_ref(*args)
        for launch in (seg_waterfill, _launch_global):
            r_k, l_k = launch(*[a.to(dev) for a in args])
            assert torch.equal(r_k.cpu(), r_p), (args[0].shape, launch)
            torch.testing.assert_close(l_k.cpu(), l_p, rtol=2e-6, atol=1e-3)
    # the one-launch variant refuses a size it does not fit
    with pytest.raises(RuntimeError, match="smem"):
        _launch_smem(*[torch.as_tensor(x).to(dev)
                       for x in random_flows(16384, 16, 6)])
    # fw_minplus: dyadic bit for bit at n = 37 and below, at and above one
    # and two tiles; random within rtol; a disconnected graph's unreachable
    # pairs stay INF
    for n, dyadic in [(37, True), (100, False)] + [(n, True)
                                                   for n in EDGE_NS]:
        A = torch.tensor(random_adjacency(n, n, dyadic), device=dev)
        D_k, D_p = floyd_warshall(A), floyd_warshall_ref(A)
        if dyadic:
            assert torch.equal(D_k, D_p), n
        torch.testing.assert_close(D_k, D_p, rtol=1e-5, atol=1e-4)
    A, apart = disconnected_adjacency(2 * TILE + 1, 6)
    D_k = floyd_warshall(torch.tensor(A, device=dev))
    assert torch.equal(D_k, floyd_warshall_ref(torch.tensor(A, device=dev)))
    assert bool((D_k.cpu()[torch.tensor(apart)] == INF).all())


@pytest.mark.cuda
def test_cuda_segment_sum_equals_cpu():
    """network.segment_sum per link on the card equals the CPU's slot-order
    sums bit for bit (and so repeats): on the paper's flows over its
    fabric, the paper shape at random and the hot link (a run of ~9600
    slots on one link, where the card's deterministic index_add_ adds in
    another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import SimConfig, build_paper_network, network
    _, net = build_paper_network(SimConfig(), device="cpu")
    r = np.random.default_rng(7)
    src, dst = (torch.tensor(r.integers(0, 20, 600)) for _ in range(2))
    active = torch.tensor(r.uniform(size=600) < 0.8)
    paper = (torch.where(active[:, None], net.path_links[src, dst], -1),
             active, net.link_bw_kbps,
             torch.tensor(r.uniform(10, 1e4, 600).astype(np.float32)))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for flows in (paper, random_flows(600, 28, 2),
                      hot_link_flows(12000, 2800, seed=5)):
            links, active, bw, tcp = (torch.as_tensor(x) for x in flows)
            E = bw.shape[0]
            valid = (links >= 0) & active[:, None]
            seg = torch.where(valid, links, E).reshape(-1).long()
            w = (tcp[:, None] * valid.float()).reshape(-1)
            cpu = network.segment_sum(w, seg, E)
            card = [network.segment_sum(w.cuda(), seg.cuda(), E).cpu()
                    for _ in range(2)]
            assert torch.equal(card[0], cpu) and torch.equal(card[1], cpu)
    finally:
        torch.use_deterministic_algorithms(was)


def free_inputs(device):
    """engine._free_resources at real size: 2000 hosts, 6000 containers
    with paper_workload's requests, a third on one host, ~80% freed."""
    from repro_torch.core import SimConfig, paper_workload, scaled_hosts
    H, C = 2000, 6000
    req = paper_workload(SimConfig(n_jobs=C // 3, n_tasks=C, n_containers=C),
                         seed=0, device=device).req
    r = np.random.default_rng(3)
    host = r.integers(-1, H, C)
    host[r.uniform(size=C) < 1 / 3] = 7
    mask = r.uniform(size=C) < 0.8
    hosts = scaled_hosts(H, H // 5, device=device)
    hosts = hosts._replace(used=hosts.cap * 0.75, n_containers=torch.full(
        (H,), C, dtype=torch.int32, device=device))
    return (hosts, req, torch.tensor(host, dtype=torch.int32, device=device),
            torch.tensor(mask, device=device))


def test_free_resources_matches_jax_at_real_size():
    """engine._free_resources on the CPU against the JAX package's on the
    real-size inputs the card test uses: bit for bit (each host's
    requests, not dyadic, added in container order on both)."""
    import jax.numpy as jnp
    from repro.core import engine as jeng
    from repro.core.types import HostState as JaxHostState
    from repro_torch.core import engine
    hosts, req, host, mask = free_inputs("cpu")
    assert int(((host == 7) & mask).sum()) > 1000
    assert not torch.equal(req, (req * 64).round() / 64)
    got = engine._free_resources(hosts, req, host, mask)
    want = jeng._free_resources(
        JaxHostState(**{k: jnp.asarray(v.numpy())
                        for k, v in hosts._asdict().items()}),
        jnp.asarray(req.numpy()), jnp.asarray(host.numpy()),
        jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(got.used.numpy(), np.asarray(want.used))
    np.testing.assert_array_equal(got.n_containers.numpy(),
                                  np.asarray(want.n_containers))


@pytest.mark.cuda
def test_cuda_free_resources_matches_cpu_at_real_size():
    """engine._free_resources on the card equals the CPU bit for bit:
    each host's requests added in container order on both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import engine
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        card = engine._free_resources(*free_inputs("cuda"))
        cpu = engine._free_resources(*free_inputs("cpu"))
        assert torch.equal(card.used.cpu(), cpu.used)
        assert torch.equal(card.n_containers.cpu(), cpu.n_containers)
    finally:
        torch.use_deterministic_algorithms(was)
