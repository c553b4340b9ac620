"""Training on one card in the port (repro_torch.train, launch.train, the
autograd Functions around the LM kernels) against the JAX package's
training code on the CPU, at the configs' ``REDUCED`` sizes, from one JAX
``TrainState`` carried across (``convert.train_state_from_jax``) and the
same numpy batches.  JAX runs jitted, as its launcher runs it; its Pallas
kernels run in interpret mode.  JAX is imported inside the tests that use
it, so the ``cuda``-marked tests also run where there is a card and no
JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train.py

Contracts:
* the chunked loss rtol 1e-5; ``lr_schedule``, ``clip_by_global_norm``
  and ``adamw_update`` rtol 1e-6 (the same f32 arithmetic in the same
  order; the sums of squares in the global norm add in each library's
  order, so the clipped gradients can be an f32 ulp apart): AdamW's
  parameters and moments within 1e-6 of each leaf's largest magnitude,
  since an element where b1 m and (1 - b1) g cancel keeps the absolute
  error of its terms;
* the loss of ``make_loss_fn`` rtol 1e-3, and every gradient leaf within
  ``GRAD_ULPS`` bf16 ulps of its largest magnitude (8, i.e. 2^-5 max|g|)
  with cosine >= 0.999.  The gradients pass bf16 roundings (the casts of
  the matmul operands), so a one-ulp flip upstream moves a leaf's
  rounding noise, and the leaves that sum many cancelling terms (A_log,
  dt_bias) show it most.  zamba2 is held to ``GRAD_ULPS_HYBRID`` = 16
  ulps (2^-4): its shared attention runs inside ``lax.cond``, which XLA
  compiles (and drops bf16 roundings in).  Measured on the CPU at this
  test's inputs: JAX's own jitted and eager (``jax.disable_jit``, no
  remat) gradients differ by up to 7.8 ulps (A_log); the port lands
  within 6.4 ulps of the eager gradient (dt_bias) and up to 13.8 ulps
  from the jitted one this test compares with (A_log); the other four
  architectures stay within 3.6;
* three train steps' losses rtol 1e-3;
* on the CPU the Functions' gradients equal the plain version's autograd
  bit for bit, and the JAX ``custom_vjp`` ops' within 1e-5 (flash, f32)
  and ``GRAD_ULPS`` (ssd, whose recompute rounds operands to bf16);
* a resumed run equals the uninterrupted one bit for bit.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,  # noqa: E402
                                       to_device)
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.distributed.fault import (FaultConfig,  # noqa: E402
                                           TrainingSupervisor)
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttentionFn, flash_attention, flash_attention_ref)
from repro_torch.kernels.ssd_scan import SSDScanFn, ssd_scan  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.config import config_from_jax  # noqa: E402
from repro_torch.models.convert import train_state_from_jax  # noqa: E402
from repro_torch.models.ssm import ssd_chunked_ref  # noqa: E402
from repro_torch.train import loss as tloss  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCHS = ["smollm_360m", "mamba2_1_3b", "zamba2_1_2b", "paligemma_3b",
         "musicgen_large"]
B, S = 2, 32           # S: a multiple of the reduced ssm_chunk (16)
GRAD_ULPS = 8
GRAD_ULPS_HYBRID = 16
LOSS_RTOL = 1e-3
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def data_cfg(cfg, seq=S, batch=B, seed=0):
    return dict(seq_len=seq, global_batch=batch, vocab=cfg.vocab, seed=seed,
                frontend=cfg.frontend, n_prefix=cfg.n_prefix,
                d_model=cfg.d_model)


def assert_grad_close(got, ref, ulps, what):
    """Max |got - ref| within ``ulps`` bf16 ulps of max |ref| (2^-8 a
    ulp), cosine >= 0.999; a leaf the loss does not reach is zero in
    both."""
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


@functools.lru_cache(maxsize=None)
def jax_start(arch):
    """JAX's ``init_train_state(PRNGKey(0))`` for the reduced ``arch``, as
    numpy, and its first batch."""
    import jax
    from repro.configs import get_reduced as jget_reduced
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.train.step import init_train_state as jinit
    jcfg = jget_reduced(arch)
    state = jax.tree.map(np.asarray, jax.jit(jinit, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0)))
    data = JSyntheticLM(JDataConfig(**data_cfg(jcfg)))
    return jcfg, state, data


def port_start(arch, impl="ref"):
    jcfg, jstate, jdata = jax_start(arch)
    cfg = dataclasses.replace(config_from_jax(jcfg), attn_impl=impl,
                              ssm_impl=impl)
    return cfg, train_state_from_jax(jstate, cfg, "cpu"), jdata


# --- loss and optimizer ------------------------------------------------------
def test_chunked_cross_entropy_matches_jax():
    import jax.numpy as jnp
    from repro.train.loss import chunked_cross_entropy as jce
    rng = np.random.default_rng(0)
    Bq, Sq, d, V, Vp = 2, 40, 16, 50, 64        # chunk 16: 2 + a ragged 8
    hidden = rng.standard_normal((Bq, Sq, d)).astype(np.float32)
    unembed = rng.standard_normal((d, Vp)).astype(np.float32)
    labels = rng.integers(0, V, (Bq, Sq)).astype(np.int32)
    labels[0, :5] = -1
    labels[1, -3:] = -1                          # masked in the ragged chunk
    nll_j, n_j = jce(jnp.asarray(hidden), jnp.asarray(unembed),
                     jnp.asarray(labels), V, chunk=16)
    nll_t, n_t = tloss.chunked_cross_entropy(
        torch.from_numpy(hidden), torch.from_numpy(unembed),
        torch.from_numpy(labels), V, chunk=16)
    np.testing.assert_allclose(float(nll_t), float(nll_j), rtol=1e-5)
    assert float(n_t) == float(n_j) == float((labels >= 0).sum())


def test_lm_loss_adds_weighted_aux():
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((1, 8, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 10, (1, 8)).astype(np.int32))
    base, m = tloss.lm_loss(h, w, lab, 10, chunk=4)
    with_aux, _ = tloss.lm_loss(h, w, lab, 10, chunk=4,
                                aux=torch.tensor(2.0), aux_weight=0.5)
    assert float(with_aux) == pytest.approx(float(base) + 1.0, rel=1e-6)
    assert float(m["ce"]) == float(base) and float(m["n_tokens"]) == 8


def test_lr_schedule_matches_jax():
    import jax.numpy as jnp
    from repro.train.optimizer import OptimizerConfig as JOpt
    from repro.train.optimizer import lr_schedule as jlr
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    steps = np.arange(0, 120, dtype=np.int32)
    want = np.asarray([jlr(JOpt(**kw), jnp.asarray(s)) for s in steps])
    got = np.asarray([float(topt.lr_schedule(topt.OptimizerConfig(**kw),
                                             torch.tensor(s)))
                      for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def random_tree(rng, scale=1.0):
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"b": {"w": f(3, 4), "a": f(5)}, "a": f(2, 2, 3)}


def test_clip_and_adamw_match_jax():
    import jax
    import jax.numpy as jnp
    from repro.train import optimizer as jopt
    rng = np.random.default_rng(2)
    params = random_tree(rng)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = topt.tree_map(torch.from_numpy, params)
    grads = random_tree(rng, 3.0)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    tc, tn = topt.clip_by_global_norm(topt.tree_map(torch.from_numpy, grads),
                                      1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(topt.tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)

    kw = dict(lr=1e-2, warmup_steps=1, total_steps=5, weight_decay=0.1)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jstate, tstate = jopt.init_opt_state(jparams), topt.init_opt_state(tparams)
    for i in range(3):
        g = random_tree(rng, 0.1 * (i + 1))
        jparams, jstate, jm = jopt.adamw_update(
            jcfg, jparams, jax.tree.map(jnp.asarray, g), jstate)
        tparams, tstate, tm = topt.adamw_update(
            tcfg, tparams, topt.tree_map(torch.from_numpy, g), tstate)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for t, j in ((tparams, jparams), (tstate.m, jstate.m),
                     (tstate.v, jstate.v)):
            for a, b in zip(topt.tree_leaves(t), jax.tree.leaves(j)):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                           atol=1e-6 * np.abs(b).max())
        assert int(tstate.step) == int(jstate.step) == i + 1


# --- the model's loss and gradients ------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    import jax
    import jax.numpy as jnp
    from repro.train.step import make_loss_fn as jmake_loss_fn
    jcfg, jstate, jdata = jax_start(arch)
    batch = jdata.batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(jmake_loss_fn(jcfg),
                                             has_aux=True))(
        jax.tree.map(jnp.asarray, jstate.params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    cfg, state, _ = port_start(arch)
    tl, metrics, tg = tstep.value_and_grad(tstep.make_loss_fn(cfg),
                                           state.params,
                                           to_device(batch, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert float(metrics["n_tokens"]) == float(
        (batch["labels"] >= 0).sum())
    ulps = GRAD_ULPS_HYBRID if cfg.family == "hybrid" else GRAD_ULPS
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    tleaves = topt.tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for (path, j), t in zip(jleaves, tleaves):
        assert t.dtype == torch.float32
        assert_grad_close(t.numpy(), np.asarray(j), ulps,
                          f"{arch} {jax.tree_util.keystr(path)}")


@functools.lru_cache(maxsize=None)
def jax_losses(arch, n_steps):
    """The losses of ``n_steps`` of the JAX train step, jitted."""
    import jax
    import jax.numpy as jnp
    from repro.train.optimizer import OptimizerConfig as JOpt
    from repro.train.step import make_train_step as jmake_step
    jcfg, jstate, jdata = jax_start(arch)
    jstep = jax.jit(jmake_step(jcfg, JOpt(**OPT)))
    js, losses = jax.tree.map(jnp.asarray, jstate), []
    for i in range(n_steps):
        batch = jdata.batch_at(i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(jm["loss"]))
    return losses


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_three_train_steps_match_jax(impl):
    """zamba2 (both LM kernels' Functions with impl 'kernel'): the JAX
    train step and the port's, three steps from one state."""
    arch = "zamba2_1_2b"
    want = jax_losses(arch, 3)
    cfg, ts, jdata = port_start(arch, impl)
    tstep_fn = tstep.make_train_step(cfg, topt.OptimizerConfig(**OPT))
    for i in range(3):
        ts, tm = tstep_fn(ts, to_device(jdata.batch_at(i), "cpu"))
        np.testing.assert_allclose(float(tm["loss"]), want[i],
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
    assert int(ts.opt.step) == 3


def test_microbatches_match_one_batch():
    """n_microbatches=2 against 1 (tests/test_train.py's contract)."""
    cfg = get_reduced("smollm_360m")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    out = {}
    for n in (1, 2):
        state = tstep.init_train_state(cfg, seed=0, device="cpu")
        step = tstep.make_train_step(cfg, topt.OptimizerConfig(),
                                     tstep.StepConfig(n_microbatches=n))
        state, metrics = step(state, batch)
        out[n] = (float(metrics["loss"]),
                  topt.tree_leaves(state.params)[0].numpy())
    assert abs(out[1][0] - out[2][0]) < 5e-3
    np.testing.assert_allclose(out[1][1], out[2][1], atol=5e-3)


def test_remat_does_not_change_gradients():
    """cfg.remat reruns each layer in the backward: the same gradients,
    bit for bit, and the kernels' Functions rerun their forward."""
    cfg = dataclasses.replace(get_reduced("zamba2_1_2b"), attn_impl="kernel",
                              ssm_impl="kernel")
    params = ttr.init_params(cfg, seed=0, device="cpu", masters=True)
    batch = to_device(SyntheticLM(DataConfig(**data_cfg(cfg))).batch_at(0),
                      "cpu")
    out = [tstep.value_and_grad(tstep.make_loss_fn(cfg), params, batch)
           for cfg in (cfg, dataclasses.replace(cfg, remat=False))]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(topt.tree_leaves(out[0][2]), topt.tree_leaves(out[1][2])):
        assert torch.equal(a, b)


def test_masters_round_to_the_serving_tree():
    cfg = get_reduced("zamba2_1_2b")
    served = ttr.init_params(cfg, seed=3, device="cpu")
    masters = ttr.init_params(cfg, seed=3, device="cpu", masters=True)
    for a, m in zip(topt.tree_leaves(served), topt.tree_leaves(masters)):
        assert m.dtype == torch.float32
        assert torch.equal(a, m.to(a.dtype))


def test_untrainable_families_raise():
    """Every family trains now (the moe family and MLA against JAX in
    tests/test_torch_train_moe.py); what still raises: MLA with the flash
    kernel (no kernel has its head dims), and compress_pod_grads without a
    mesh with a 'pod' axis."""
    for arch in ("olmoe_1b_7b", "deepseek_v2_236b"):
        cfg = get_reduced(arch)
        assert not hasattr(tstep, "check_trainable")
        tstep.make_train_step(cfg, topt.OptimizerConfig())
        tstep.init_train_state(cfg, seed=0, device="cpu")
    mla = dataclasses.replace(get_reduced("deepseek_v2_236b"),
                              attn_impl="kernel")
    with pytest.raises(ValueError, match="MLA"):
        tstep.init_train_state(mla, seed=0, device="cpu")
    with pytest.raises(ValueError, match="pod"):
        tstep.make_train_step(get_reduced("smollm_360m"),
                              topt.OptimizerConfig(),
                              tstep.StepConfig(compress_pod_grads=True))


# --- the kernels' autograd Functions -----------------------------------------
def flash_inputs(seed, B=2, S=48, Hq=4, Hkv=2, D=16):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                      (B, S, Hq, D))]


def ssd_inputs(seed, B=2, S=48, H=4, P=8, N=8):
    r = np.random.default_rng(seed)
    return [(r.standard_normal((B, S, H, P)) * 0.5).astype(np.float32),
            (r.standard_normal((B, S, N)) * 0.5).astype(np.float32),
            (r.standard_normal((B, S, N)) * 0.5).astype(np.float32),
            r.uniform(0.01, 0.2, (B, S, H)).astype(np.float32),
            r.uniform(-1, 0.5, (H,)).astype(np.float32),
            r.standard_normal((B, S, H, P)).astype(np.float32)]


def leaves_with_grad(arrays, device="cpu"):
    return [torch.tensor(a, device=device).requires_grad_(True)
            for a in arrays]


def test_functions_equal_plain_autograd_on_cpu():
    *qkv, g = flash_inputs(0)
    a, b = leaves_with_grad(qkv), leaves_with_grad(qkv)
    go = torch.from_numpy(g)
    o = FlashAttentionFn.apply(*a, True, None)
    assert torch.equal(o, flash_attention_ref(*b))
    ga = torch.autograd.grad(o, a, go)
    gb = torch.autograd.grad(flash_attention_ref(*b), b, go)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))

    *ins, g = ssd_inputs(1)
    a, b = leaves_with_grad(ins), leaves_with_grad(ins)
    y, h = SSDScanFn.apply(*a, 16)
    y_ref, _ = ssd_chunked_ref(*b, 16)
    ga = torch.autograd.grad(y, a, torch.from_numpy(g))     # h unused
    gb = torch.autograd.grad(y_ref, b, torch.from_numpy(g))
    assert len(ga) == 5
    assert all(torch.equal(x, z) for x, z in zip(ga, gb))


def test_ssd_vjp_is_finite_where_the_decay_overflows():
    """A chunk of 256 with dt 0.7 and A = -1 spreads its decays to ~178:
    exp overflows above the diagonal.  The JAX reference's VJP is NaN in
    dt and A_log there (a fault of the reference, ROADMAP Queue 3); the
    port masks the decay before exp and stays finite, with the forward
    unchanged."""
    import jax
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked_ref as jref
    *ins, g = ssd_inputs(8, B=1, S=256, H=2, P=4, N=4)
    ins[3] = np.full_like(ins[3], 0.7)
    ins[4] = np.zeros_like(ins[4])
    jg = jax.jit(jax.grad(lambda *a: (jref(*a, 256)[0] * g).sum(),
                          argnums=tuple(range(5))))(*map(jnp.asarray, ins))
    assert [bool(np.isnan(np.asarray(x)).any()) for x in jg] == [
        False, False, False, True, True]
    a = leaves_with_grad(ins)
    y, _ = ssd_chunked_ref(*a, 256)
    tg = torch.autograd.grad(y, a, torch.from_numpy(g))
    assert all(bool(torch.isfinite(x).all()) for x in tg)
    y_j, _ = jref(*map(jnp.asarray, ins), 256)
    assert_grad_close(y.detach().numpy(), np.asarray(y_j), 4, "y")
    for name, x, ref in zip(("xs", "Bm", "Cm"), tg, jg):
        assert_grad_close(x.numpy(), np.asarray(ref), GRAD_ULPS, name)


def test_functions_grads_match_jax_ops():
    """Against the JAX package's custom_vjp ops (Pallas in interpret mode
    forward, the jnp reference's VJP backward)."""
    import jax
    import jax.numpy as jnp
    from repro.kernels.flash_attention import ops as fa_ops
    from repro.kernels.ssd_scan import ops as ssd_ops
    *qkv, g = flash_inputs(2, B=1, S=32, Hq=2, Hkv=1)
    o_j, vjp = jax.vjp(lambda q, k, v: fa_ops.flash_attention(q, k, v, True),
                       *map(jnp.asarray, qkv))
    gj = vjp(jnp.asarray(g))
    a = leaves_with_grad(qkv)
    o_t = FlashAttentionFn.apply(*a, True, None)
    gt = torch.autograd.grad(o_t, a, torch.from_numpy(g))
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                               rtol=1e-5, atol=1e-5)
    for x, y in zip(gt, gj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5)

    *ins, g = ssd_inputs(3, B=1, S=32, H=2)
    (y_j, h_j), vjp = jax.vjp(
        lambda *xs: ssd_ops.ssd_chunked(*xs, Q=16), *map(jnp.asarray, ins))
    gj = vjp((jnp.asarray(g), jnp.zeros_like(h_j)))
    a = leaves_with_grad(ins)
    y_t, _ = SSDScanFn.apply(*a, 16)
    gt = torch.autograd.grad(y_t, a, torch.from_numpy(g))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=1e-4, atol=1e-4)
    for name, x, y in zip(("xs", "Bm", "Cm", "dt", "A_log"), gt, gj):
        assert_grad_close(x.numpy(), np.asarray(y), GRAD_ULPS, name)


# --- checkpoints, resume, the supervisor -------------------------------------
def test_jax_train_state_checkpoint_restores_into_port(tmp_path):
    from repro.distributed import checkpoint as jckpt
    jcfg, jstate, _ = jax_start("zamba2_1_2b")
    jckpt.save_checkpoint(str(tmp_path / "step_3"), jstate, 3)
    cfg = config_from_jax(jcfg)
    like = tstep.init_train_state(cfg, seed=1, device="cpu")
    got, step = ckpt.restore_checkpoint(str(tmp_path / "step_3"), like)
    want = train_state_from_jax(jstate, cfg, "cpu")
    assert step == 3 and isinstance(got, tstep.TrainState)
    assert isinstance(got.opt, topt.OptState)
    got_l, want_l = topt.tree_leaves(got), topt.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        assert a.dtype == b.dtype and torch.equal(a, b)


def run_cli(tmp_path, *extra):
    return ttrain.main(["--device", "cpu", "--reduced", "--arch",
                        "zamba2-1.2b", "--steps", "4", "--batch", "2",
                        "--seq", "32", "--log-every", "1", *extra])


def test_resume_equals_uninterrupted_run(tmp_path):
    """launch.train with --ckpt-dir: checkpoints at steps 2 and 4; a run
    restored from step 2 ends bit for bit where the uninterrupted run
    ended, and replays its steps 2 and 3 exactly."""
    d = str(tmp_path / "ck")
    full = run_cli(tmp_path, "--ckpt-dir", d, "--ckpt-every", "2")
    assert sorted(os.listdir(d)) == ["step_2", "step_4"]
    assert full["start_step"] == 0 and len(full["losses"]) == 4
    for name in os.listdir(os.path.join(d, "step_4")):
        os.remove(os.path.join(d, "step_4", name))
    os.rmdir(os.path.join(d, "step_4"))
    resumed = run_cli(tmp_path, "--ckpt-dir", d, "--ckpt-every", "2")
    assert resumed["start_step"] == 2
    assert resumed["losses"] == full["losses"][2:]
    a, b = topt.tree_leaves(full["state"]), topt.tree_leaves(resumed["state"])
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(resumed["state"].opt.step) == 4
    assert resumed["launches"]["flash_attention"] == 0     # CPU: plain


def test_training_supervisor_matches_jax():
    from repro.distributed.fault import FaultConfig as JFault
    from repro.distributed.fault import TrainingSupervisor as JSup
    for sup_cls, cfg_cls in ((TrainingSupervisor, FaultConfig),
                             (JSup, JFault)):
        saved = []
        sup = sup_cls(cfg_cls(max_restarts=2), 3, save_fn=saved.append,
                      restore_fn=lambda: 6)
        assert [sup.maybe_checkpoint(s) for s in range(8)] == [
            False, False, False, True, False, False, True, False]
        assert saved == [3, 6]
        assert sup.recover() == 6 and sup.recover() == 6
        with pytest.raises(RuntimeError, match="budget"):
            sup.recover()


# --- on the card ------------------------------------------------------------
def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "interpreter (chip_smoke.py phase 9 runs these checks "
                    "on the card)")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


@pytest.mark.cuda
def test_cuda_raw_wrappers_refuse_requires_grad():
    needs_cuda()
    *qkv, _ = flash_inputs(4, S=64, D=64)
    q, k, v = (torch.tensor(a, device="cuda").bfloat16() for a in qkv)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_attention(q.requires_grad_(True), k, v)
    *ins, _ = ssd_inputs(5, S=64, P=32, N=16)
    t = [torch.tensor(a, device="cuda") for a in ins]
    t[3].requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        ssd_scan(*t, 16)


@pytest.mark.cuda
def test_cuda_functions_equal_plain_autograd():
    needs_cuda()
    *qkv, g = flash_inputs(6, S=256, Hq=4, Hkv=4, D=64)
    a = [t.to("cuda").bfloat16().requires_grad_(True)
         for t in map(torch.tensor, qkv)]
    b = [t.detach().clone().requires_grad_(True) for t in a]
    go = torch.tensor(g, device="cuda").bfloat16()
    before = LAUNCHES["flash_attention"]
    o = FlashAttentionFn.apply(*a, True, None)
    assert LAUNCHES["flash_attention"] == before + 1
    with torch.no_grad():
        assert torch.equal(o, flash_attention(*[t.detach() for t in a]))
    ga = torch.autograd.grad(o, a, go)
    gb = torch.autograd.grad(flash_attention_ref(*b), b, go)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))

    *ins, g = ssd_inputs(7, S=128, H=4, P=64, N=64)
    a = leaves_with_grad(ins, "cuda")
    b = leaves_with_grad(ins, "cuda")
    y, _ = SSDScanFn.apply(*a, 64)
    ga = torch.autograd.grad(y, a, torch.tensor(g, device="cuda"))
    gb = torch.autograd.grad(ssd_chunked_ref(*b, 64)[0], b,
                             torch.tensor(g, device="cuda"))
    assert all(torch.equal(x, z) for x, z in zip(ga, gb))


@pytest.mark.cuda
def test_cuda_model_trains_through_the_kernels():
    """Reduced zamba2, 3 steps on the card (kernels) against the CPU run
    (plain versions) from one state: losses rtol 1e-3; each step launches
    each kernel twice a layer that runs it (forward and remat rerun)."""
    needs_cuda()
    cfg = dataclasses.replace(get_reduced("zamba2_1_2b"), attn_impl="kernel",
                              ssm_impl="kernel")
    cpu = tstep.init_train_state(cfg, seed=0, device="cpu")
    gpu = topt.tree_map(lambda t: t.to("cuda"), cpu)
    step = tstep.make_train_step(cfg, topt.OptimizerConfig(**OPT))
    data = SyntheticLM(DataConfig(**data_cfg(cfg, seq=64, batch=4)))
    for i in range(3):
        batch = data.batch_at(i)
        cpu, mc = step(cpu, to_device(batch, "cpu"))
        before = dict(LAUNCHES)
        gpu, mg = step(gpu, to_device(batch, "cuda"))
        got = {k: LAUNCHES[k] - before[k] for k in ("flash_attention",
                                                    "ssd_scan")}
        assert got == {"flash_attention": 2 * (cfg.n_layers
                                               // cfg.attn_every),
                       "ssd_scan": 2 * cfg.n_layers}
        np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]),
                                   rtol=LOSS_RTOL)
