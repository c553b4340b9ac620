"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's kernels run as its own tests run them — Pallas in interpret
mode — and against its jnp references; kernel selection; and, on a card,
each CUDA kernel against its plain version.  JAX is imported inside the
tests that use it, so the ``cuda``-marked test also runs where there is a
card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py

Contracts: seg_waterfill rates bit for bit, load within rtol 2e-6;
fw_minplus bit for bit on dyadic weights, rtol 1e-5 otherwise.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.kernels import LAUNCHES, resolve_kernel  # noqa: E402
from repro_torch.kernels.fw_minplus import (floyd_warshall,  # noqa: E402
                                            floyd_warshall_ref)
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
                                      (30, False)])
def test_fw_matches_jax_interpret_and_ref(n, dyadic):
    import jax.numpy as jnp
    from repro.core import network as jnet
    from repro.kernels.fw_minplus import ops as jfw_ops
    A = random_adjacency(n, n, dyadic)
    D_int = np.asarray(jfw_ops.floyd_warshall(jnp.asarray(A), bs=16,
                                              interpret=True))
    D_ref = np.asarray(jnet.floyd_warshall_ref(jnp.asarray(A)))
    D_t = floyd_warshall(torch.tensor(A)).numpy()
    # the plain versions follow the same pivot order: bit for bit
    np.testing.assert_array_equal(D_t, D_ref)
    if dyadic:
        np.testing.assert_array_equal(D_t, D_int)
    else:
        np.testing.assert_allclose(D_t, D_int, rtol=1e-5, atol=1e-4)
    assert torch.equal(floyd_warshall_ref(torch.tensor(A)),
                       torch.tensor(D_t))


def test_fw_disconnected_stays_inf():
    A = np.full((6, 6), INF, np.float32)
    np.fill_diagonal(A, 0.0)
    A[0, 1] = A[1, 0] = 1.5
    D = floyd_warshall(torch.tensor(A)).numpy()
    assert D[0, 1] == 1.5 and D[0, 2] == INF and D[2, 2] == 0.0


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
    for n, dyadic in [(37, True), (100, False)]:
        A = torch.tensor(random_adjacency(n, n, dyadic), device=dev)
        D_k, D_p = floyd_warshall(A), floyd_warshall_ref(A)
        if dyadic:
            assert torch.equal(D_k, D_p)
        torch.testing.assert_close(D_k, D_p, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_cuda_plain_segment_sum_repeats_within_f32_bound():
    """The contract network.segment_sum_slots keeps on the card, where
    deterministic index_add_ need not add in slot order: the same sums from
    run to run, each within the error bound of any f32 order of its n
    adds (n * 2**-24 * the sum of magnitudes, twice: one per side) of the
    CPU's slot-order sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import network
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for flows in (random_flows(600, 28, 2),
                      hot_link_flows(12000, 2800, seed=5)):
            links, active, bw, tcp = (torch.as_tensor(x) for x in flows)
            E = bw.shape[0]
            valid = (links >= 0) & active[:, None]
            seg = torch.where(valid, links, E).reshape(-1).long()
            w = (tcp[:, None] * valid.float()).reshape(-1)
            cpu = network.segment_sum_slots(w, seg, E)
            card = [network.segment_sum_slots(w.cuda(), seg.cuda(), E).cpu()
                    for _ in range(2)]
            assert torch.equal(card[0], card[1])
            n = torch.zeros(E + 1).index_add_(0, seg, valid.float().reshape(-1))
            mag = torch.zeros(E + 1, dtype=torch.float64).index_add_(
                0, seg, w.double().abs())
            limit = (2 * n * 2.0 ** -24 * mag)[:E]
            assert bool(((card[0].double() - cpu.double()).abs()
                         <= limit).all())
    finally:
        torch.use_deterministic_algorithms(was)
