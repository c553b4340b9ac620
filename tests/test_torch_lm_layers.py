"""The port's LM layers (repro_torch.models.layers / ssm) against the JAX
package's, module by module, on the same numpy inputs with JAX run op by
op (eager), as its source is written.

Contract: within ONE bf16 ulp of each output's largest magnitude
(``ulp_bf16``).  Both packages round every bf16 matmul output once from an
f32 sum; only the summation order can differ, and it can move a result
across one rounding boundary.  (On this CPU most modules agree bit for
bit.)  f32 outputs of the same modules are held to the same bound.

The last test shows why the whole-model tests of test_torch_lm_serve.py
need a looser bound: under ``jax.jit`` XLA drops the bf16 rounding of
``(x_bf16 @ W_bf16).astype(f32)`` that the source writes, and the port
keeps it.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.config import config_from_jax  # noqa: E402

IMPLS = [("xla", "ref"), ("pallas", "kernel")]
B, S, d = 2, 32, 64


def ulp_bf16(m: float) -> float:
    """One bf16 ulp at magnitude ``m`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def assert_within_ulps(got, ref, ulps=1):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape
    tol = ulps * ulp_bf16(max(float(np.abs(ref).max()), 1e-30))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def both(a, dtype="bfloat16"):
    """The same numpy array as a JAX array and a torch tensor."""
    return jnp.asarray(a, getattr(jnp, dtype)), torch.tensor(a).to(
        getattr(torch, dtype))


def test_rmsnorm():
    jx, tx = both(rnd(B, S, d, seed=1))
    w = 1 + 0.1 * rnd(d, seed=2)
    assert_within_ulps(tlayers.rmsnorm(tx, torch.tensor(w)),
                       jlayers.rmsnorm(jx, jnp.asarray(w)))


def test_rope():
    pos = np.arange(S)
    jc, js = jlayers.rope_angles(jnp.asarray(pos), 16)
    tc, ts = tlayers.rope_angles(torch.tensor(pos), 16)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    jq, tq = both(rnd(B, S, 4, 16, seed=3))
    out = tlayers.apply_rope(tq, tc, ts)
    assert out.dtype == torch.bfloat16     # bf16 x f32 tables, cast back
    assert_within_ulps(out, jlayers.apply_rope(jq, jc, js))


@pytest.mark.parametrize("Hq,Hkv,causal,valid", [(4, 4, True, None),
                                                 (4, 2, True, None),
                                                 (6, 2, False, 20)])
def test_attention_ref(Hq, Hkv, causal, valid):
    """bf16-rounded operands, f32 results (preferred_element_type=F32)."""
    Sq = S if valid is None else 1
    jq, tq = both(rnd(B, Sq, Hq, 16, seed=4))
    jk, tk = both(rnd(B, S, Hkv, 16, seed=5))
    jv, tv = both(rnd(B, S, Hkv, 16, seed=6))
    out = tlayers.attention_ref(tq, tk, tv, causal=causal,
                                kv_valid_len=valid)
    assert out.dtype == torch.float32
    assert_within_ulps(out, jlayers.attention_ref(
        jq, jk, jv, causal=causal,
        kv_valid_len=None if valid is None else jnp.int32(valid)))


def test_mlp():
    jx, tx = both(rnd(B, S, d, seed=7))
    p = {"w_gate": rnd(d, 128, seed=8, scale=d ** -0.5),
         "w_up": rnd(d, 128, seed=9, scale=d ** -0.5),
         "w_down": rnd(128, d, seed=10, scale=128 ** -0.5)}
    out = tlayers.mlp({k: torch.tensor(v) for k, v in p.items()}, tx)
    assert out.dtype == torch.bfloat16
    assert_within_ulps(out, jlayers.mlp(
        {k: jnp.asarray(v) for k, v in p.items()}, jx))


def attn_params(Hq, Hkv, D, bias, seed):
    shapes = {"wq": (d, Hq * D), "wk": (d, Hkv * D), "wv": (d, Hkv * D),
              "wo": (Hq * D, d)}
    p = {k: rnd(*s, seed=seed + i, scale=s[0] ** -0.5)
         for i, (k, s) in enumerate(shapes.items())}
    if bias:
        p.update(bq=rnd(Hq * D, seed=seed + 5, scale=0.1),
                 bk=rnd(Hkv * D, seed=seed + 6, scale=0.1),
                 bv=rnd(Hkv * D, seed=seed + 7, scale=0.1))
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.tensor(v) for k, v in p.items()})


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
@pytest.mark.parametrize("bias", [False, True])
def test_attn_block_prefill_and_cache(jimpl, timpl, bias):
    Hq, Hkv, D, T = 4, 2, 16, S + 4
    jp, tp = attn_params(Hq, Hkv, D, bias, seed=11)
    kw = dict(n_heads=Hq, n_kv_heads=Hkv, d_head=D, rope_theta=1e4)
    jx, tx = both(rnd(B, S, d, seed=12))
    jo, (jk, jv) = jlayers.attn_block(jp, jx, positions=jnp.arange(S),
                                      impl=jimpl, **kw)
    to, (tk, tv) = tlayers.attn_block(tp, tx, positions=torch.arange(S),
                                      impl=timpl, **kw)
    for got, ref in ((to, jo), (tk, jk), (tv, jv)):
        assert got.dtype == torch.bfloat16
        assert_within_ulps(got, ref)

    # cache mode: one new token at position S against a T-slot cache
    jkc = jnp.zeros((B, T, Hkv, D), jnp.bfloat16).at[:, :S].set(jk)
    jvc = jnp.zeros((B, T, Hkv, D), jnp.bfloat16).at[:, :S].set(jv)
    tkc, tvc = torch.tensor(np.asarray(jkc, np.float32)).bfloat16(), \
        torch.tensor(np.asarray(jvc, np.float32)).bfloat16()
    jx1, tx1 = both(rnd(B, 1, d, seed=13))
    jo, (jkc, jvc) = jlayers.attn_block(
        jp, jx1, positions=jnp.arange(1) + S, impl=jimpl,
        cache_kv=(jkc, jvc), cache_len=jnp.int32(S), **kw)
    to, (tkc2, tvc2) = tlayers.attn_block(
        tp, tx1, positions=torch.arange(1) + S, impl=timpl,
        cache_kv=(tkc, tvc), cache_len=S, **kw)
    assert tkc2 is tkc and tvc2 is tvc        # updated in place
    for got, ref in ((to, jo), (tkc, jkc), (tvc, jvc)):
        assert_within_ulps(got, ref)


def ssm_case(arch, jimpl, seed):
    jcfg = dataclasses.replace(jget_reduced(arch), ssm_impl=jimpl)
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    r = np.random.default_rng(seed)
    H = jcfg.n_ssm_heads
    jp = dict(jp, A_log=jnp.asarray(r.uniform(-1, 0.5, H), jnp.float32),
              dt_bias=jnp.asarray(r.uniform(-1, 0, H), jnp.float32))
    tp = {k: torch.tensor(np.array(v)) for k, v in jp.items()}
    return jcfg, jp, tp


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
@pytest.mark.parametrize("arch,seq", [("zamba2_1_2b", 32),
                                      ("mamba2_1_3b", 48)])
def test_ssm_block_train_and_decode(arch, seq, jimpl, timpl):
    jcfg, jp, tp = ssm_case(arch, jimpl, seed=14)
    tcfg = config_from_jax(jcfg)
    jx, tx = both(rnd(B, seq, jcfg.d_model, seed=15))
    jo, (jh, jconv) = jssm.ssm_block(jp, jx, jcfg, impl=jimpl)
    to, (th, tconv) = tssm.ssm_block(tp, tx, tcfg, impl=timpl)
    assert to.dtype == torch.bfloat16 and th.dtype == torch.float32
    for got, ref in ((to, jo), (th, jh), (tconv, jconv)):
        assert_within_ulps(got, ref)

    # the O(1) recurrent step from the prefill's state
    jx1, tx1 = both(rnd(B, 1, jcfg.d_model, seed=16))
    jo, (jh2, jconv2) = jssm.ssm_block(jp, jx1, jcfg, mode="decode",
                                       state=(jh, jconv), impl=jimpl)
    to, (th2, tconv2) = tssm.ssm_block(
        tp, tx1, tcfg, mode="decode",
        state=(torch.tensor(np.asarray(jh)), torch.tensor(np.asarray(jconv))),
        impl=timpl)
    for got, ref in ((to, jo), (th2, jh2), (tconv2, jconv2)):
        assert_within_ulps(got, ref)


def test_ssd_chunked_ref_zero_pads_a_ragged_sequence():
    r = np.random.default_rng(17)
    xs, Bm, Cm = (r.standard_normal(s).astype(np.float32) * 0.5
                  for s in ((1, 40, 2, 16), (1, 40, 8), (1, 40, 8)))
    dt = r.uniform(0.01, 0.2, (1, 40, 2)).astype(np.float32)
    A_log = r.uniform(-1, 0.5, 2).astype(np.float32)
    jy, jh = jssm.ssd_chunked_ref(*(jnp.asarray(a) for a in
                                    (xs, Bm, Cm, dt, A_log)), 16)
    ty, th = tssm.ssd_chunked_ref(*(torch.tensor(a) for a in
                                    (xs, Bm, Cm, dt, A_log)), 16)
    assert ty.shape == (1, 40, 2, 16)
    assert_within_ulps(ty, jy)
    assert_within_ulps(th, jh)


def test_unknown_impl_raises():
    jx, tx = both(rnd(1, 4, 2, 16, seed=18))
    with pytest.raises(ValueError, match="impl"):
        tlayers.attention(tx, tx, tx, impl="pallas")


def test_jit_drops_the_bf16_rounding_the_port_keeps():
    """The model head ``(h_bf16 @ W_bf16).astype(f32)``: the port rounds
    the product to bf16 as the source says, as eager JAX does; under
    ``jax.jit`` XLA fuses the convert into the dot and returns the
    unrounded f32 sum.  The gap is up to half a bf16 ulp per such op, and
    flips carried through a bf16 residual stream grow it, which is why
    test_torch_lm_serve.py holds jitted whole models to 4 ulps."""
    jh, th = both(rnd(2, d, seed=19))
    W = rnd(d, 256, seed=20, scale=d ** -0.5)
    head = lambda h, W: (h.astype(jnp.bfloat16)
                         @ W.astype(jnp.bfloat16)).astype(jnp.float32)
    eager = np.asarray(head(jh, jnp.asarray(W)))
    jitted = np.asarray(jax.jit(head)(jh, jnp.asarray(W)))
    port = (th @ torch.tensor(W).bfloat16()).float().numpy()
    np.testing.assert_array_equal(port, eager)
    assert np.abs(jitted - eager).max() > 0          # jit did not round
    assert_within_ulps(torch.tensor(jitted), eager, ulps=0.5)
