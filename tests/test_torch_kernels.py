"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's kernels run as its own tests run them — Pallas in interpret
mode — and against its jnp references; kernel selection; and, on a card,
each CUDA kernel against its plain version.

Contracts: seg_waterfill rates bit for bit, load within rtol 2e-6;
fw_minplus bit for bit on dyadic weights, rtol 1e-5 otherwise.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import network as jnet  # noqa: E402
from repro.kernels.fw_minplus import ops as jfw_ops  # noqa: E402
from repro.kernels.seg_waterfill import ops as jwf_ops  # noqa: E402
from repro.kernels.seg_waterfill.ref import (  # noqa: E402
    seg_waterfill_ref as jwf_ref)
from repro_torch.kernels import LAUNCHES, resolve_kernel  # noqa: E402
from repro_torch.kernels.fw_minplus import (floyd_warshall,  # noqa: E402
                                            floyd_warshall_ref)
from repro_torch.kernels.seg_waterfill import (seg_waterfill,  # noqa: E402
                                               seg_waterfill_ref)

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


# --- fw_minplus -------------------------------------------------------------
@pytest.mark.parametrize("n,dyadic", [(37, True), (37, False), (8, True),
                                      (30, False)])
def test_fw_matches_jax_interpret_and_ref(n, dyadic):
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
    for F, E, seed in [(8, 5, 0), (600, 140, 1)]:
        args = [torch.tensor(x, device=dev) for x in random_flows(F, E, seed)]
        r_k, l_k = seg_waterfill(*args)
        r_p, l_p = seg_waterfill_ref(*args)
        assert torch.equal(r_k, r_p)
        torch.testing.assert_close(l_k, l_p, rtol=2e-6, atol=1e-3)
    for n, dyadic in [(37, True), (100, False)]:
        A = torch.tensor(random_adjacency(n, n, dyadic), device=dev)
        D_k, D_p = floyd_warshall(A), floyd_warshall_ref(A)
        if dyadic:
            assert torch.equal(D_k, D_p)
        torch.testing.assert_close(D_k, D_p, rtol=1e-5, atol=1e-4)
