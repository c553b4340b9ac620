"""repro_torch.core.network against repro.core.network on identical numpy
inputs: topology tables, the sparse and dense flow engines, the adjacency,
the delay refresh in both modes, and the leftover-flow regression."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import network as jnet  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core.convert import assert_state_close, to_torch  # noqa: E402

SCALES = [(20, 4), (100, 20)]   # (hosts, leaves): paper scale and 100 hosts


def nets(n_hosts, n_leaf, **kw):
    jspec = jnet.SpineLeafSpec(n_hosts=n_hosts, n_leaf=n_leaf, **kw)
    tspec = tnet.SpineLeafSpec(n_hosts=n_hosts, n_leaf=n_leaf, **kw)
    return (jspec, jax.device_get(jnet.build_network(jspec)),
            tspec, tnet.build_network(tspec, device="cpu"))


def with_util(jn, seed):
    """Both nets with the same random link utilization."""
    u = np.random.default_rng(seed).uniform(0, 1, jn.link_util.shape)
    jn = jn._replace(link_util=u.astype(np.float32))
    return jn, to_torch(jn, "cpu")


def flows(n_hosts, n_flows, seed):
    r = np.random.default_rng(seed)
    return (r.integers(0, n_hosts, n_flows).astype(np.int32),
            r.integers(0, n_hosts, n_flows).astype(np.int32),
            r.random(n_flows) < 0.8)


@pytest.mark.parametrize("n_hosts,n_leaf", SCALES)
def test_build_network_matches(n_hosts, n_leaf):
    _, jn, _, tn = nets(n_hosts, n_leaf, loss=0.01)
    assert_state_close(jn, tn, rtol=1e-6, atol=0.0)
    # integer tables exactly, and the delay sums bit for bit
    np.testing.assert_array_equal(np.asarray(jn.delay_matrix),
                                  tn.delay_matrix.numpy())


@pytest.mark.parametrize("n_hosts,n_leaf", SCALES)
@pytest.mark.parametrize("n_rounds", [1, 8])
def test_max_min_fair_sparse_matches(n_hosts, n_leaf, n_rounds):
    _, jn, _, tn = nets(n_hosts, n_leaf)
    for seed in range(2):
        src, dst, active = flows(n_hosts, 6 * n_hosts, seed)
        links = np.where(active[:, None],
                         np.asarray(jn.path_links)[src, dst], -1)
        bw = np.random.default_rng(seed).uniform(
            1e3, 1.25e5, jn.link_bw.shape).astype(np.float32)
        ref = np.asarray(jnet.max_min_fair_rates_sparse(
            jnp.asarray(links), jnp.asarray(active), jnp.asarray(bw),
            n_rounds=n_rounds))
        got = tnet.max_min_fair_rates_sparse(
            torch.tensor(links), torch.tensor(active), torch.tensor(bw),
            n_rounds=n_rounds).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_hosts,n_leaf,sparse,loss", [
    (20, 4, True, 0.0), (20, 4, True, 0.01), (20, 4, False, 0.0),
    (100, 20, True, 0.0), (100, 20, False, 0.01)])
def test_flow_rates_matches(n_hosts, n_leaf, sparse, loss):
    _, jn, _, tn = nets(n_hosts, n_leaf, loss=loss)
    jn, tn = with_util(jn, 1)
    src, dst, active = flows(n_hosts, 4 * n_hosts, 2)
    jr, ju = jnet.flow_rates(jn, jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(active), sparse=sparse)
    tr, tu = tnet.flow_rates(tn, torch.tensor(src), torch.tensor(dst),
                             torch.tensor(active), sparse=sparse)
    # log1p/exp of the loss differ by an ulp between the two libraries
    rtol = 0 if loss == 0 and sparse else 1e-5
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=rtol)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=max(rtol, 1e-6),
                               atol=1e-7)


@pytest.mark.parametrize("n_hosts,n_leaf", SCALES)
def test_dense_oracle_matches_sparse(n_hosts, n_leaf):
    _, _, _, tn = nets(n_hosts, n_leaf)
    for seed in range(5):
        src, dst, active = flows(n_hosts, int(2 * n_hosts), seed)
        args = (torch.tensor(src), torch.tensor(dst), torch.tensor(active))
        r_s, u_s = tnet.flow_rates(tn, *args, sparse=True)
        r_d, u_d = tnet.flow_rates(tn, *args, sparse=False)
        torch.testing.assert_close(r_s, r_d, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(u_s, u_d, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_hosts,n_leaf", SCALES)
def test_adjacency_matches(n_hosts, n_leaf):
    jspec, jn, tspec, tn = nets(n_hosts, n_leaf)
    jn, tn = with_util(jn, 3)
    d = jnet.congested_link_delay(jn)
    A_j = np.asarray(jnet.adjacency_from_links(jn, d, jspec.n_nodes))
    A_t = tnet.adjacency_from_links(
        tn, tnet.congested_link_delay(tn), tspec.n_nodes).numpy()
    np.testing.assert_array_equal(A_t, A_j)


@pytest.mark.parametrize("n_hosts,n_leaf", SCALES)
@pytest.mark.parametrize("mode", ["path", "fw"])
def test_update_delay_matrix_matches(n_hosts, n_leaf, mode):
    jspec, jn, tspec, tn = nets(n_hosts, n_leaf)
    jn, tn = with_util(jn, 4)
    j = jax.device_get(jnet.update_delay_matrix(
        jn, jspec.n_hosts, jspec.n_nodes, mode=mode, q_coef=0.5,
        util_weight=1.0, cross_leaf_ms=0.05))
    t = tnet.update_delay_matrix(tn, tspec.n_hosts, tspec.n_nodes,
                                 mode=mode, q_coef=0.5, util_weight=1.0,
                                 cross_leaf_ms=0.05)
    np.testing.assert_array_equal(t.delay_matrix.numpy(),
                                  np.asarray(j.delay_matrix))
    np.testing.assert_array_equal(t.comm_cost.numpy(),
                                  np.asarray(j.comm_cost))


def test_update_delay_matrix_rejects_unknown_mode():
    spec = tnet.SpineLeafSpec()
    with pytest.raises(ValueError, match="delay mode"):
        tnet.update_delay_matrix(tnet.build_network(spec, device="cpu"),
                                 spec.n_hosts, spec.n_nodes, mode="bogus")


def many_bottleneck_net(n):
    """20-host fabric whose first n host uplinks have distinct bandwidths
    (tests/test_flow_sparse.py's leftover-flow case)."""
    spec = tnet.SpineLeafSpec()
    net = tnet.build_network(spec, device="cpu")
    bw = net.link_bw.clone()
    bw[:n] = torch.linspace(100.0, 900.0, n)
    return spec, net._replace(link_bw=bw,
                              link_bw_kbps=bw * tnet.MBPS_TO_KBPS)


def test_leftover_flows_bounded_regression():
    """More distinct bottleneck levels than rounds: the flows left unfrozen
    get their fair-share bound, not the 4 GB/s loopback rate, in both
    engines, and the engines agree."""
    n = 10
    spec, net = many_bottleneck_net(n)
    src = torch.arange(n, dtype=torch.int32)
    dst = src + 10
    active = torch.ones(n, dtype=torch.bool)
    bw = net.link_bw_kbps
    out = {}
    for sparse in (True, False):
        rates, _ = tnet.flow_rates(net, src, dst, active, n_rounds=8,
                                   sparse=sparse)
        assert (rates <= bw[:n] * 1.02 + 1e-3).all(), rates
        out[sparse] = rates
    torch.testing.assert_close(out[True], out[False], rtol=1e-4, atol=1e-3)
    links = net.path_links[src.long(), dst.long()]
    for n_rounds in (2, 4, 8):
        sp = tnet.max_min_fair_rates_sparse(links, active, bw, n_rounds)
        assert float(sp.max()) < 1e6, f"n_rounds={n_rounds}: kept alloc0"


def test_set_link_params_rejects_sentinels():
    net = tnet.build_network(tnet.SpineLeafSpec(), device="cpu")
    with pytest.raises(ValueError):
        tnet.set_link_params(net, bw=0.0)
    with pytest.raises(ValueError):
        tnet.set_link_params(net, loss=-0.1)
    lossy = tnet.set_link_params(net, bw=200.0, loss=0.02)
    assert float(lossy.link_bw.max()) == 200.0
    assert float(lossy.path_loss.max()) > 0.0


# --- the ordered segment sum -------------------------------------------------
def _fold_in_row_order(values, seg, n_segments):
    """Each segment's rows added one after another in row order, in f32."""
    out = np.zeros((n_segments,) + values.shape[1:], np.float32)
    for v, s in zip(values, seg):
        out[s] = (out[s] + v).astype(np.float32)
    return out


@pytest.mark.parametrize("N,n_seg,cols,seed", [
    (0, 3, 0, 0), (1, 1, 0, 1), (500, 7, 0, 2), (3000, 2, 0, 3),
    (600, 29, 3, 4), (6000, 2001, 3, 5)])
def test_segment_sum_adds_in_row_order(N, n_seg, cols, seed):
    """network.segment_sum against a row-order f32 fold, against the CPU's
    index_add_ and the JAX package's segment_sum on the CPU: bit for bit,
    empty segments 0, the rows of pad id n_seg dropped."""
    r = np.random.default_rng(seed)
    shape = (N,) if cols == 0 else (N, cols)
    values = r.uniform(0.1, 1e4, shape).astype(np.float32)
    seg = r.integers(0, max(n_seg - 1, 1), N)   # the last segment stays empty
    seg[r.uniform(size=N) < 0.2] = n_seg        # pads
    got = tnet.segment_sum(torch.tensor(values), torch.tensor(seg), n_seg)
    assert got.shape == (n_seg,) + shape[1:]
    np.testing.assert_array_equal(
        got.numpy(), _fold_in_row_order(values, seg, n_seg + 1)[:n_seg])
    ref = torch.zeros((n_seg + 1,) + shape[1:]).index_add_(
        0, torch.tensor(seg), torch.tensor(values))[:n_seg]
    assert torch.equal(got, ref)
    jax_sum = jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(seg),
                                  num_segments=n_seg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_sum))
