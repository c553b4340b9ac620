"""Training the moe family and MLA in the port (repro_torch.train.step,
models.moe) against the JAX package on the CPU, at the configs'
``REDUCED`` sizes, from one JAX ``TrainState`` carried across
(``convert.train_state_from_jax``) and the same numpy batches.

The JAX side runs under ``make_mesh_for(1, 1)``, as its training launcher
does on one device: its ``moe_layer`` takes the expert-parallel body at
one model shard (``_ep_shard`` with ``moe_impl='psum'``, ``_ep_a2a_shard``
with ``'a2a'``), which the port computes with ``mesh=None``.  JAX runs
jitted; every JAX ``router_topk`` call hands its top-k indices to a debug
callback (the JAX code is observed, not changed), and the port's routing
is held to them (``moe.log_routing(replay=...)``): top-k is discontinuous,
and a near tie that two summation orders rank apart must be within
``moe.NEAR_TIE_ULPS`` bf16 ulps of the router logits, else the port
raises.  Under remat the JAX callback fires again in the backward's
rerun; the forward's calls come first.

Contracts:
* the loss rtol 1e-3 and every gradient leaf within ``GRAD_ULPS`` (8)
  bf16 ulps of its largest magnitude, cosine >= 0.999
  (``tests/test_torch_train.py``'s contract), for olmoe with both
  ``moe_impl`` and deepseek-v2 (MLA through ``attention_ref``);
* three train steps' losses rtol 1e-3 (olmoe, deepseek-v2; JAX's steps
  are its jitted gradient and jitted ``adamw_update``, ``make_train_step``'s
  composition at one microbatch).  After the
  first AdamW step the two packages' parameters differ: the first update
  is about +-lr an element (m / sqrt(v) of one gradient), so where an
  element's gradient is near zero and the packages' summation orders give
  it opposite signs, the update differs by 2 lr.  That moves router logits
  by more than a near tie of summation order (measured on the CPU: 2.5
  bf16 ulps on olmoe, 11.4 on deepseek-v2 at the second step).  Unheld,
  one flipped choice moves the queue at an expert's capacity, and the
  losses part by 1.3e-3 to 3.3e-3 at steps 2-3.  So steps 2-3 replay
  JAX's routing with ``STEP_TIE_ULPS`` (16) as the bound, the first step
  with ``NEAR_TIE_ULPS``;
* at one model shard the port's a2a body equals its psum body bit for
  bit, forward and gradients;
* a dropped assignment's gradient is zero: a token whose k assignments
  are all dropped at capacity gets no gradient through the moe layer, in
  the port and in JAX.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import config_from_jax  # noqa: E402
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.models.transformer import cast_bf16_leaves  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

CASES = [("olmoe_1b_7b", "psum"), ("olmoe_1b_7b", "a2a"),
         ("deepseek_v2_236b", "psum")]
B, S = 2, 32
GRAD_ULPS = 8
LOSS_RTOL = 1e-3
STEP_TIE_ULPS = 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def data_cfg(cfg):
    return dict(seq_len=S, global_batch=B, vocab=cfg.vocab, seed=0,
                frontend=cfg.frontend, n_prefix=cfg.n_prefix,
                d_model=cfg.d_model)


def assert_grad_close(got, ref, ulps, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    m = np.abs(ref).max()
    if m == 0:
        assert not got.any(), what
        return
    gap = np.abs(got - ref).max()
    assert gap <= ulps * 2.0 ** -8 * m, \
        f"{what}: {gap / (2.0 ** -8 * m):.2f} bf16 ulps of max |g|"
    cos = (got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref))
    assert cos >= 0.999, f"{what}: cosine {cos:.6f}"


class recording_routes:
    """Within the block, every JAX ``router_topk`` call also hands its
    top-k indices to ``sink`` (a debug callback, in call order).  A
    program traced in an earlier block keeps its callback, which appends
    to the sink of the block open when it runs."""

    active = None

    def __init__(self, sink):
        self.sink = sink

    def __enter__(self):
        import jax
        from repro.models import moe as jmoe
        self.jmoe, self.orig = jmoe, jmoe.router_topk
        recording_routes.active = self.sink

        def wrapped(params, x, cfg):
            topw, topi, aux = self.orig(params, x, cfg)
            jax.debug.callback(
                lambda t: recording_routes.active.append(np.array(t)),
                topi, ordered=True)
            return topw, topi, aux
        jmoe.router_topk = wrapped

    def __exit__(self, *exc):
        import jax
        jax.effects_barrier()
        self.jmoe.router_topk = self.orig
        recording_routes.active = None


def n_moe(cfg) -> int:
    return cfg.n_layers - cfg.first_dense


def forward_calls(routes, cfg, n_programs):
    """The forward's routing of each of ``n_programs`` jitted calls: each
    records its n_moe forward calls, then the remat rerun's."""
    n = n_moe(cfg)
    assert len(routes) == 2 * n * n_programs
    return [routes[2 * n * i: 2 * n * i + n] for i in range(n_programs)]


@functools.lru_cache(maxsize=None)
def jax_start(arch):
    """JAX's reduced config, its init_train_state(PRNGKey(0)) and the
    first three batches."""
    import jax
    from repro.configs import get_reduced as jget_reduced
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.train.step import init_train_state as jinit
    jcfg = jget_reduced(arch)
    state = jax.jit(jinit, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    data = JSyntheticLM(JDataConfig(**data_cfg(jcfg)))
    return jcfg, state, [data.batch_at(i) for i in range(3)]


def jnp_batch(batch):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_grad_fn(arch, impl):
    """JAX's ``value_and_grad`` of ``make_loss_fn`` under the one-device
    mesh, jitted, with moe_impl ``impl``, and its config."""
    import jax
    from repro.launch.mesh import make_mesh_for
    from repro.train.step import make_loss_fn as jmake_loss_fn
    jcfg = dataclasses.replace(jax_start(arch)[0], moe_impl=impl)
    return jcfg, jax.jit(jax.value_and_grad(
        jmake_loss_fn(jcfg, mesh=make_mesh_for(1, 1)), has_aux=True))


def jax_value_and_grad(arch, impl, params, batch):
    """(loss, grads, the forward's routing) of one jitted call."""
    import jax
    jcfg, fn = jax_grad_fn(arch, impl)
    routes = []
    with recording_routes(routes):
        (loss, _), grads = fn(params, jnp_batch(batch))
        jax.block_until_ready(grads)
    return float(loss), grads, forward_calls(routes, jcfg, 1)[0]


@functools.lru_cache(maxsize=None)
def jax_steps(arch):
    """JAX's three train steps: the jitted gradient above, then
    ``adamw_update`` (``make_train_step``'s composition at one microbatch
    and no compression): each loss and each step's routing."""
    import jax
    from repro.train import optimizer as jopt
    from repro.train.step import TrainState as JTrainState
    jcfg, state, batches = jax_start(arch)
    adamw = jax.jit(functools.partial(jopt.adamw_update,
                                      jopt.OptimizerConfig(**OPT)))
    losses, routes = [], []
    for b in batches:
        loss, grads, r = jax_value_and_grad(arch, "psum", state.params, b)
        params, opt, _ = adamw(state.params, grads, state.opt)
        state = JTrainState(params, opt)
        losses.append(loss)
        routes.append(r)
    return losses, routes


def port_state(arch, impl="psum"):
    import jax
    jcfg, state, _ = jax_start(arch)
    cfg = dataclasses.replace(config_from_jax(jcfg), moe_impl=impl)
    return cfg, train_state_from_jax(jax.tree.map(np.asarray, state), cfg,
                                     "cpu")


@pytest.mark.parametrize("arch,impl", CASES)
def test_loss_and_grads_match_jax(arch, impl):
    import jax
    jloss, jgrads, routes = jax_value_and_grad(
        arch, impl, jax_start(arch)[1].params, jax_start(arch)[2][0])
    jgrads = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    cfg, state = port_state(arch, impl)
    assert config_from_jax(jax_grad_fn(arch, impl)[0]) == cfg
    with tmoe.log_routing(replay=routes) as log:
        loss, metrics, grads = tstep.value_and_grad(
            tstep.make_loss_fn(cfg), state.params,
            to_device(jax_start(arch)[2][0], "cpu"))
    assert len(log.topi) == n_moe(cfg)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    tleaves = topt.tree_leaves(grads)
    assert len(tleaves) == len(jgrads)
    for (path, g), t in zip(jgrads, tleaves):
        assert t.dtype == torch.float32
        assert_grad_close(t.numpy(), np.asarray(g), GRAD_ULPS,
                          f"{arch} {impl} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v2_236b"])
def test_three_train_steps_match_jax(arch):
    """The first step's routing is held to JAX's at NEAR_TIE_ULPS; the
    later steps' at STEP_TIE_ULPS (see the module docstring)."""
    losses, step_routes = jax_steps(arch)
    cfg, ts = port_state(arch)
    step = tstep.make_train_step(cfg, topt.OptimizerConfig(**OPT))
    for i, routes in enumerate(step_routes):
        batch = to_device(jax_start(arch)[2][i], "cpu")
        with tmoe.log_routing(replay=routes, tie_ulps=(
                tmoe.NEAR_TIE_ULPS if i == 0 else STEP_TIE_ULPS)):
            ts, m = step(ts, batch)
        np.testing.assert_allclose(float(m["loss"]), losses[i],
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
    assert int(ts.opt.step) == 3


def moe_params(seed=1):
    """Reduced olmoe's JAX moe parameters (numpy) and x [2, 32, d] bf16
    values (f32 numpy) skewed so that every token routes to experts 0
    and 1: C = 24 of the 64 assignments each are kept."""
    import jax
    from repro.configs import get_reduced as jget_reduced
    from repro.models import moe as jmoe
    jcfg = jget_reduced("olmoe_1b_7b")
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed),
                                               jcfg))
    router = np.zeros_like(p["router"])
    router[:, 0], router[:, 1] = 0.05, 0.03
    p["router"] = router
    x = np.abs(np.random.default_rng(seed).standard_normal(
        (2, 32, jcfg.d_model)))
    x = np.asarray(torch.from_numpy(x.astype(np.float32))
                   .to(torch.bfloat16).float())
    return jcfg, p, x


def test_dropped_assignments_get_no_gradient():
    import jax
    import jax.numpy as jnp
    from repro.launch.mesh import make_mesh_for
    from repro.models import moe as jmoe
    jcfg, p, x = moe_params()
    cfg = config_from_jax(jcfg)
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(xj):
        y, _ = jmoe.moe_layer(p, xj, jcfg, make_mesh_for(1, 1))
        return jnp.sum(y.astype(jnp.float32) * g)
    jg = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x, jnp.bfloat16)),
                    np.float32)

    tp = cast_bf16_leaves({"moe": {k: torch.tensor(v)
                                   for k, v in p.items()}})["moe"]
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    with tmoe.log_routing() as log:
        y, _ = tmoe.moe_layer(tp, xt, cfg)
    (tg,) = torch.autograd.grad((y.float() * torch.from_numpy(g)).sum(), xt)
    tg = tg.float().numpy()
    C = tmoe.capacity(64, cfg)
    assert C == 24 and int(log.drops[0][1]) == 2 * (64 - C)
    assert np.array_equal(log.topi[0].reshape(-1, 2)[0].numpy(), [0, 1])
    flat_t, flat_j = tg.reshape(64, -1), jg.reshape(64, -1)
    # tokens C.. have both assignments dropped: no gradient at all
    assert not flat_t[C:].any() and not flat_j[C:].any()
    assert flat_t[:C].any()
    assert_grad_close(tg, jg, GRAD_ULPS, "x through the moe layer")


def test_a2a_equals_psum_on_one_card():
    """At one model shard the a2a body keeps every assignment on the send
    side and packs by expert in arrival order, as the psum body does."""
    jcfg, p, x = moe_params(seed=3)
    p["router"] = np.random.default_rng(3).standard_normal(
        p["router"].shape).astype(np.float32) * 0.02
    out = {}
    for impl in ("psum", "a2a"):
        cfg = dataclasses.replace(config_from_jax(jcfg), moe_impl=impl)
        tp = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in p.items()}
        xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
        y, aux = tmoe.moe_layer(tp, xt, cfg)
        gy = torch.from_numpy(np.random.default_rng(4).standard_normal(
            y.shape).astype(np.float32))
        grads = torch.autograd.grad((y.float() * gy).sum() + aux,
                                    [xt, *tp.values()])
        out[impl] = (y, aux, grads)
    (y0, a0, g0), (y1, a1, g1) = out["psum"], out["a2a"]
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
