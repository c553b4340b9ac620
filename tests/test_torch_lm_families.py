"""The port's moe family, MLA and the patch/frame frontends
(repro_torch.models.{moe,mla,transformer}, serve.step, launch.serve)
against the JAX package on the reduced olmoe, deepseek-v2, paligemma and
musicgen configs, on the CPU.

The JAX side runs under ``make_mesh_for(1, 1)``, as
``python -m repro.launch.serve`` does on one device: its ``moe_layer``
then takes the expert-parallel path (``_ep_shard`` at one model shard,
capacity C, assignments past C dropped), which is what the port's
``moe_layer`` computes; ``moe_layer_dense`` (the oracle, no drop) is held
to JAX's oracle apart.

Contracts:
* routing on the same input: top-k indices equal (ties to the lower
  index, as ``jax.lax.top_k``), the dispatch's keep/slot integers equal
  to those ``_ep_shard`` computes (``moe.py:101-112``, evaluated on JAX's
  indices), the layer's output within ``MODEL_ULPS`` bf16 ulps of its
  largest magnitude (the combine adds in bf16 in the same order; the
  grouped products sum in another order);
* whole models (JAX jitted, as in test_torch_lm_serve.py): logits and
  cache leaves within ``MODEL_ULPS``.  Top-k is discontinuous: two runs
  whose sums differ in order can rank a near tie apart, and under
  ``jax.jit`` XLA drops bf16 roundings the source writes (on reduced
  deepseek one of 8 jitted decode steps lands 0.56 from the eager one's
  logits, the others within 0.04).  So the port's routing is held to JAX's, call by call
  (``moe.log_routing(replay=...)``): wherever the indices differ, each
  differing pair's router logits must be within ``moe.NEAR_TIE_ULPS``
  bf16 ulps of each other, else the port raises;
* generated tokens equal wherever JAX's top-2 margin exceeds twice the
  logits bound, up to the first step whose margin is not clear.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch.mesh import make_mesh_for  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve.step import _load_prefill as jload_prefill  # noqa: E402
from repro.serve.step import generate as jgenerate  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.config import config_from_jax  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.step import _load_prefill as tload_prefill  # noqa: E402
from repro_torch.serve.step import generate as tgenerate  # noqa: E402

MOE = ["olmoe_1b_7b", "deepseek_v2_236b"]
ARCHS = MOE + ["paligemma_3b", "musicgen_large"]
CASES = [("olmoe_1b_7b", "xla"), ("olmoe_1b_7b", "pallas"),
         ("deepseek_v2_236b", "xla"),       # MLA: no kernel (see below)
         ("paligemma_3b", "xla"), ("paligemma_3b", "pallas"),
         ("musicgen_large", "xla"), ("musicgen_large", "pallas")]
B, S, T = 2, 32, 8
MODEL_ULPS = 4
BF16 = torch.bfloat16


def ulp_bf16(m: float) -> float:
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def tol_for(ref) -> float:
    return MODEL_ULPS * ulp_bf16(max(float(np.abs(ref).max()), 1e-30))


def assert_model_close(got, ref, what):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol_for(ref),
                               err_msg=what)


def cache_leaves(cache):
    """Leaves in JAX's tree order (dict keys sorted, tuples in order)."""
    return [leaf for k in sorted(cache) for leaf in cache[k]]


def to_torch(a):
    """A JAX or numpy array as a CPU tensor of the same type (bf16 exact
    through f32)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF16)
    return torch.from_numpy(np.array(a))


def cli_batch(jcfg, seed, B=B, S=S):
    """The JAX serve CLI's prompt batch (``repro/launch/serve.py:40-51``,
    line for line)."""
    rng = np.random.default_rng(seed)
    if jcfg.frontend == "patch_embeds":
        return {"patch_embeds": jnp.asarray(
                    rng.standard_normal((B, jcfg.n_prefix, jcfg.d_model)),
                    jnp.bfloat16),
                "tokens": jnp.asarray(
                    rng.integers(0, jcfg.vocab, (B, S - jcfg.n_prefix)),
                    jnp.int32)}
    if jcfg.frontend == "frame_embeds":
        return {"frame_embeds": jnp.asarray(
            rng.standard_normal((B, S, jcfg.d_model)), jnp.bfloat16)}
    return {"tokens": jnp.asarray(rng.integers(0, jcfg.vocab, (B, S)),
                                  jnp.int32)}


class recording_routes:
    """Within the block, every JAX ``router_topk`` call also hands its
    top-k indices to ``sink`` (a debug callback, in call order, under jit
    too); the JAX code is not changed, only observed."""

    def __init__(self, sink):
        self.sink = sink

    def __enter__(self):
        self.orig = jmoe.router_topk

        def wrapped(params, x, cfg):
            topw, topi, aux = self.orig(params, x, cfg)
            jax.debug.callback(lambda t: self.sink.append(np.array(t)),
                               topi, ordered=True)
            return topw, topi, aux
        jmoe.router_topk = wrapped

    def __exit__(self, *exc):
        jmoe.router_topk = self.orig


@functools.lru_cache(maxsize=None)
def jax_run(arch, jimpl):
    """JAX's side under the one-device mesh, jitted, computed once per
    worker: prefill logits and cache, the greedy generate tokens, the
    teacher-forced decode logits with those tokens fed and the forward's
    hidden state, with the routing of every moe call of each."""
    jcfg = dataclasses.replace(jget_reduced(arch), attn_impl=jimpl,
                               ssm_impl=jimpl)
    mesh = make_mesh_for(1, 1)
    params = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    batch = cli_batch(jcfg, 1)
    routes = {k: [] for k in ("prefill", "generate", "decode", "forward")}
    with recording_routes(routes["prefill"]):
        logits, cache, _ = jax.jit(functools.partial(
            jtr.prefill, jcfg, mesh=mesh))(params, batch)
        jax.effects_barrier()
    with recording_routes(routes["generate"]):
        gen = np.asarray(jax.jit(functools.partial(
            jgenerate, jcfg, n_steps=T, mesh=mesh))(params, batch))
        jax.effects_barrier()
    first = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
    feed = np.concatenate([first[:, None], gen[:, :-1]], axis=1)
    full = jload_prefill(jcfg, jtr.init_cache(jcfg, B, S + T), cache, S)
    step = jax.jit(functools.partial(jtr.decode_step, jcfg, mesh=mesh))
    dec = []
    with recording_routes(routes["decode"]):
        for t in range(T):
            lg, full = step(params, jnp.asarray(feed[:, t:t + 1]), full,
                            jnp.array(S + t, jnp.int32))
            dec.append(np.asarray(lg))
        jax.effects_barrier()
    with recording_routes(routes["forward"]):
        hidden, aux = jax.jit(functools.partial(
            jtr.forward_train, jcfg, mesh=mesh))(params, batch)
        jax.effects_barrier()
    return dict(cfg=jcfg, params=jax.tree.map(np.asarray, params),
                batch={k: to_torch(v) for k, v in batch.items()},
                logits=np.asarray(logits),
                cache=[np.asarray(a, np.float32) for a in
                       jax.tree.leaves(cache)],
                gen=gen, feed=feed, dec=dec,
                hidden=np.asarray(hidden, np.float32), aux=float(aux),
                routes=routes)


def port_side(arch, jimpl):
    j = jax_run(arch, jimpl)
    cfg = config_from_jax(j["cfg"])
    return j, cfg, params_from_jax(j["params"], cfg, "cpu"), j["batch"]


def n_moe_calls(cfg) -> int:
    return cfg.n_layers - cfg.first_dense if cfg.n_experts else 0


cases = pytest.mark.parametrize("arch,jimpl", CASES)


# ---------------------------------------------------------------------------
# The moe layer on the same input
# ---------------------------------------------------------------------------
def moe_inputs(arch, skew: bool, seed=2):
    """JAX's reduced moe parameters, the port's copy, and x [2, 32, d] in
    bf16; ``skew`` adds 3 r0/|r0| (r0: the router's column 0) to every
    token, so expert 0 overflows its capacity."""
    jcfg = jget_reduced(arch)
    cfg = config_from_jax(jcfg)
    p = jmoe.init_moe(jax.random.PRNGKey(1), jcfg)
    tp = ttr.cast_bf16_leaves({"moe": jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), p)})["moe"]
    x = np.random.default_rng(seed).standard_normal((2, 32, jcfg.d_model))
    if skew:
        r0 = np.asarray(p["router"])[:, 0]
        x = x + 3 * r0 / np.linalg.norm(r0)
    xj = jnp.asarray(x.astype(np.float32), jnp.bfloat16)
    return jcfg, cfg, p, tp, xj, to_torch(xj)


@pytest.mark.parametrize("arch", MOE)
def test_router_topk_matches_jax(arch):
    jcfg, cfg, p, tp, xj, xt = moe_inputs(arch, skew=False)
    jw, ji, jaux = jmoe.router_topk(p, xj, jcfg)
    tw, ti, taux = tmoe.router_topk(tp, xt, cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_router_ties_go_to_the_lower_index(arch):
    """Router columns 1, 4 and 6 equal: their logits tie exactly in both
    packages, and both rank the tied experts in index order."""
    jcfg, cfg, p, tp, xj, xt = moe_inputs(arch, skew=False)
    r = np.asarray(p["router"]).copy()
    r[:, 4] = r[:, 6] = r[:, 1]
    p = dict(p, router=jnp.asarray(r))
    tp = dict(tp, router=torch.from_numpy(r).to(BF16))
    _, ji, _ = jmoe.router_topk(p, xj, jcfg)
    _, ti, _ = tmoe.router_topk(tp, xt, cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    ti = ti.numpy().reshape(-1, cfg.top_k)
    tied_first = np.isin(ti[:, 0], (1, 4, 6))
    assert tied_first.sum() > 0
    np.testing.assert_array_equal(ti[tied_first][:, :2],
                                  np.tile([1, 4], (tied_first.sum(), 1)))
    x = torch.tensor([[3.0, 1.0, 3.0, 2.0, 3.0]])
    assert tmoe.top_k(x, 3)[1].tolist() == [[0, 2, 4]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(x.numpy()), 3)[1]).tolist() \
        == [[0, 2, 4]]


def ep_shard_slots(topi, jcfg):
    """``_ep_shard``'s rank/keep/slot at one model shard (moe.py:101-112),
    evaluated on JAX's indices."""
    ek = topi.reshape(-1)
    T = ek.shape[0] // jcfg.top_k
    E_l, C = jcfg.n_experts, jmoe._capacity(T, jcfg)
    e_loc = ek
    in_range = (e_loc >= 0) & (e_loc < E_l)
    e_bucket = jnp.where(in_range, e_loc, E_l)
    onehot = jax.nn.one_hot(e_bucket, E_l + 1, dtype=jnp.int32)
    rank = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1,
                               e_bucket[:, None], axis=1)[:, 0]
    keep = in_range & (rank < C)
    slot = jnp.where(keep, e_loc * C + rank, E_l * C)
    return np.asarray(keep), np.asarray(slot), C


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_moe_dispatch_matches_ep_shard(arch, skew):
    jcfg, cfg, p, tp, xj, xt = moe_inputs(arch, skew)
    mesh = make_mesh_for(1, 1)
    jy, jaux = jmoe.moe_layer(p, xj, jcfg, mesh)
    assert jmoe.moe_layer is not jmoe.moe_layer_dense
    _, ji, _ = jmoe.router_topk(p, xj, jcfg)
    _, ti, _ = tmoe.router_topk(tp, xt, cfg)
    keep, slot, C = tmoe.dispatch_slots(ti, cfg)
    jkeep, jslot, jC = ep_shard_slots(ji, jcfg)
    assert C == jC
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    dropped = int((~keep).sum())
    assert (dropped > 0) == skew, dropped
    ty, taux = tmoe.moe_layer(tp, xt, cfg)
    assert ty.dtype == BF16
    assert_model_close(ty, jy, "moe_layer against _ep_shard")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    # the drop is what the two paths compute: the dense oracle differs
    dense, _ = jmoe.moe_layer_dense(p, xj, jcfg)
    gap = np.abs(np.asarray(dense, np.float32) - ty.float().numpy()).max()
    assert (gap > 10 * tol_for(np.asarray(jy, np.float32))) == skew, gap


@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_dense_matches_jax(arch):
    jcfg, cfg, p, tp, xj, xt = moe_inputs(arch, skew=True)
    jy, jaux = jmoe.moe_layer_dense(p, xj, jcfg)
    ty, taux = tmoe.moe_layer_dense(tp, xt, cfg)
    assert_model_close(ty, jy, "moe_layer_dense")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_routing_replay_refuses_what_is_no_near_tie():
    jcfg, cfg, p, tp, xj, xt = moe_inputs("olmoe_1b_7b", skew=False)
    _, ti, _ = tmoe.router_topk(tp, xt, cfg)
    with tmoe.log_routing(replay=[ti]) as log:
        tmoe.moe_layer(tp, xt, cfg)
    assert log.replaced == [0] and torch.equal(log.topi[0], ti)
    wrong = ti.flip(-1)          # the second choice first: not a tie
    with pytest.raises(RuntimeError, match="not a near tie"):
        with tmoe.log_routing(replay=[wrong]):
            tmoe.moe_layer(tp, xt, cfg)


# ---------------------------------------------------------------------------
# MLA on the same input
# ---------------------------------------------------------------------------
def mla_inputs(Sq, seed):
    jcfg = jget_reduced("deepseek_v2_236b")
    cfg = config_from_jax(jcfg)
    p = jmla.init_mla(jax.random.PRNGKey(3), jcfg)
    tp = ttr.cast_bf16_leaves(jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), p))
    x = np.random.default_rng(seed).standard_normal((B, Sq, jcfg.d_model))
    xj = jnp.asarray(x.astype(np.float32), jnp.bfloat16)
    return jcfg, cfg, p, tp, xj, to_torch(xj)


def test_mla_prefill_matches_jax():
    jcfg, cfg, p, tp, xj, xt = mla_inputs(S, 4)
    jo, (jc, jk) = jmla.mla_prefill(p, xj, jcfg, jnp.arange(S))
    to, (tc, tk) = tmla.mla_prefill(tp, xt, cfg, torch.arange(S))
    assert tc.shape == (B, S, cfg.kv_lora_rank)
    assert tk.shape == (B, S, cfg.qk_rope_dim)
    for got, ref, what in ((to, jo, "out"), (tc, jc, "c_kv"),
                           (tk, jk, "k_rope")):
        assert_model_close(got, ref, what)


def test_mla_decode_matches_jax():
    """The absorbed decode over a cache of 12 prefilled positions, 3 steps
    (the cache written in place in the port)."""
    jcfg, cfg, p, tp, xj, xt = mla_inputs(12, 5)
    _, (jc, jk) = jmla.mla_prefill(p, xj, jcfg, jnp.arange(12))
    R, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    jcache = (jnp.zeros((B, 16, R), jnp.bfloat16).at[:, :12].set(jc),
              jnp.zeros((B, 16, dr), jnp.bfloat16).at[:, :12].set(jk))
    tcache = (torch.zeros((B, 16, R), dtype=BF16),
              torch.zeros((B, 16, dr), dtype=BF16))
    tcache[0][:, :12], tcache[1][:, :12] = to_torch(jc), to_torch(jk)
    rng = np.random.default_rng(6)
    for t in range(12, 15):
        xn = jnp.asarray(rng.standard_normal((B, 1, jcfg.d_model)),
                         jnp.bfloat16)
        jo, jcache = jmla.mla_decode(p, xn, jcfg, jnp.asarray([t]), jcache,
                                     t)
        to, tcache = tmla.mla_decode(tp, to_torch(xn), cfg,
                                     torch.tensor([t]), tcache, t)
        assert_model_close(to, jo, f"decode at {t}")
        for got, ref in zip(tcache, jcache):
            assert_model_close(got, ref, f"cache at {t}")


def test_mla_with_the_kernel_raises():
    cfg = dataclasses.replace(get_reduced("deepseek-v2-236b"),
                              attn_impl="kernel")
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        ttr.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="attn_impl='ref'"):
        ttr.init_cache(cfg, 1, 8, device="cpu")
    ttr.check_supported(dataclasses.replace(cfg, attn_impl="ref"))


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------
@cases
def test_prefill_matches_jax(arch, jimpl):
    j, cfg, params, batch = port_side(arch, jimpl)
    with tmoe.log_routing(replay=j["routes"]["prefill"]) as log:
        logits, cache, seq_len = ttr.prefill(cfg, params, batch)
    assert len(log.topi) == n_moe_calls(cfg)
    assert seq_len == S and logits.dtype == torch.float32
    assert_model_close(logits, j["logits"], "prefill logits")
    leaves = cache_leaves(cache)
    assert len(leaves) == len(j["cache"])
    for i, (got, ref) in enumerate(zip(leaves, j["cache"])):
        assert_model_close(got, ref, f"cache leaf {i}")


@cases
def test_decode_teacher_forced_matches_jax(arch, jimpl):
    j, cfg, params, batch = port_side(arch, jimpl)
    with tmoe.log_routing(replay=j["routes"]["prefill"]):
        _, pf_cache, _ = ttr.prefill(cfg, params, batch)
    cache = tload_prefill(cfg, ttr.init_cache(cfg, B, S + T, device="cpu"),
                          pf_cache, S)
    with tmoe.log_routing(replay=j["routes"]["decode"]) as log:
        for t in range(T):
            lg, cache = ttr.decode_step(
                cfg, params, torch.from_numpy(j["feed"][:, t:t + 1]),
                cache, S + t)
            assert_model_close(lg, j["dec"][t], f"decode step {t}")
    assert len(log.topi) == T * n_moe_calls(cfg)


def top2_margin(logits):
    top = np.sort(logits, axis=-1)
    return top[:, -1] - top[:, -2]


@cases
def test_generate_matches_jax_where_the_margin_is_clear(arch, jimpl):
    """The port's greedy generate, its routing held to JAX's generate.
    Step by step with JAX's tokens fed, the port's greedy choice equals
    JAX's in each row until a step at which they differ, and there only
    where JAX's top-2 margin is not clear (<= twice the logits bound); at
    least half the row-steps compare at a clear margin.  The port's
    generate, run for the steps whose fed tokens agree in every row,
    returns JAX's tokens."""
    j, cfg, params, batch = port_side(arch, jimpl)
    with tmoe.log_routing(replay=j["routes"]["prefill"]):
        logits, pf_cache, _ = ttr.prefill(cfg, params, batch)
    cache = tload_prefill(cfg, ttr.init_cache(cfg, B, S + T, device="cpu"),
                          pf_cache, S)
    port = [logits.argmax(-1).numpy()]
    with tmoe.log_routing(replay=j["routes"]["decode"]):
        for t in range(T):
            lg, cache = ttr.decode_step(
                cfg, params, torch.from_numpy(j["feed"][:, t:t + 1]),
                cache, S + t)
            port.append(lg.argmax(-1).numpy())
    want = [j["feed"][:, 0]] + [j["gen"][:, t] for t in range(T)]
    steps = [j["logits"]] + j["dec"]     # the logits each choice comes from
    compared, firsts = 0, []
    for b in range(B):
        d = next((i for i in range(T + 1) if port[i][b] != want[i][b]),
                 T + 1)
        if d <= T:
            assert top2_margin(steps[d])[b] <= 2 * tol_for(steps[d]), (b, d)
        compared += sum(top2_margin(steps[i])[b] > 2 * tol_for(steps[i])
                        for i in range(d))
        firsts.append(d)
    assert compared >= B * (T + 1) // 2, compared
    n = min(min(firsts), T)     # generate's steps whose fed tokens agree
    assert n > 0
    with tmoe.log_routing(replay=j["routes"]["generate"]):
        toks = tgenerate(cfg, params, batch, n)
    assert toks.dtype == torch.int32 and toks.shape == (B, n)
    np.testing.assert_array_equal(toks.numpy()[:, :n - 1],
                                  j["gen"][:, :n - 1])


@cases
def test_forward_train_matches_jax(arch, jimpl):
    j, cfg, params, batch = port_side(arch, jimpl)
    with tmoe.log_routing(replay=j["routes"]["forward"]):
        hidden, aux = ttr.forward_train(cfg, params, batch)
    assert_model_close(hidden, j["hidden"], "hidden")
    if cfg.n_experts:
        assert 0 < float(aux)
        # p_mean moves with the router logits' bf16 roundings
        np.testing.assert_allclose(float(aux), j["aux"], rtol=2 ** -8)
    else:
        assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v2_236b",
                                  "paligemma_3b"])
def test_decode_matches_forward(arch):
    """The port's own cache check (as test_torch_lm_serve.py's):
    teacher-forced decode logits follow the full forward's position by
    position, on one sequence of 16 (paligemma: 8 patch embeddings, then
    text).  The capacity factor is raised to E / k, so that C holds every
    token and the forward, like the decode steps, drops nothing."""
    cfg = get_reduced(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    params = ttr.init_params(cfg, seed=0, device="cpu")
    n, half, n_p = 16, 8, cfg.n_prefix
    batch = {k: to_torch(v) for k, v in cli_batch(cfg, 1, B=1, S=n).items()}
    with tmoe.log_routing() as log:
        hidden, _ = ttr.forward_train(cfg, params, batch)
    assert tmoe.dropped_share(log.drops) == 0.0
    full = (hidden.to(BF16) @ params["unembed"]).float()
    text = batch["tokens"]
    _, pf_cache, _ = ttr.prefill(cfg, params,
                                 dict(batch, tokens=text[:, :half - n_p]))
    cache = tload_prefill(cfg, ttr.init_cache(cfg, 1, n, device="cpu"),
                          pf_cache, half)
    for t in range(half, n):
        lg, cache = ttr.decode_step(cfg, params,
                                    text[:, t - n_p:t - n_p + 1], cache, t)
        ref, got = full[0, t].numpy(), lg[0].numpy()
        corr = float(ref @ got) / (np.linalg.norm(ref) * np.linalg.norm(got)
                                   + 1e-9)
        assert corr > 0.99, (arch, t, corr)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    jcfg = jget_reduced(arch)
    jc = jax.eval_shape(lambda: jtr.init_cache(jcfg, 3, 40))
    tc = ttr.init_cache(config_from_jax(jcfg), 3, 40, device="cpu")
    assert sorted(tc) == sorted(jc)
    want = [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(jc)]
    got = [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
           for a in cache_leaves(tc)]
    assert got == want
    assert all(not a.any() for a in cache_leaves(tc))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """Same names and shapes as JAX's tree (deepseek's leading dense layer
    under ``first_blocks``); the bf16 leaves in bf16."""
    jcfg = jget_reduced(arch)
    jp = jax.eval_shape(lambda: jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = ttr.init_params(config_from_jax(jcfg), seed=0, device="cpu")
    jflat = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            if isinstance(v, dict):
                walk(v, key)
            else:
                tflat[key] = tuple(v.shape)
                want = BF16 if k in ttr.BF16_LEAVES else torch.float32
                assert v.dtype == want, key
    walk(tp, "")
    assert tflat == jflat
    assert ("first_blocks" in tp) == bool(jcfg.first_dense)


@pytest.mark.parametrize("arch", ARCHS)
def test_prompt_batch_draws_the_jax_clis_arrays(arch):
    """``launch.serve.prompt_batch`` draws what the JAX serve CLI draws,
    in its order, array for array."""
    cfg = get_reduced(arch)
    want = cli_batch(cfg, 7, B=3, S=24)
    got = tserve.prompt_batch(cfg, 3, 24, 7, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        w = to_torch(want[k])
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_serve_launcher_serves_a_frontend_and_a_moe_model_on_cpu():
    for arch, impl in (("musicgen-large", "kernel"),
                       ("deepseek-v2-236b", "ref")):
        out = tserve.main(["--device", "cpu", "--reduced", "--arch", arch,
                           "--batch", "2", "--prompt-len", "16", "--gen",
                           "3", "--impl", impl])
        cfg = dataclasses.replace(get_reduced(arch), attn_impl=impl,
                                  ssm_impl=impl)
        params = ttr.init_params(cfg, seed=0, device="cpu")
        batch = tserve.prompt_batch(cfg, 2, 16, 0, "cpu")
        assert torch.equal(out["tokens"], tgenerate(cfg, params, batch, 3))
        assert not any(out["prefill_launches"].values())
