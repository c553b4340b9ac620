"""The port's LM kernel wrappers on the CPU (their plain versions) against
the JAX package's Pallas kernels run as its own tests run them (through
``ops.py``, which takes the interpreter on the CPU) and against its jnp
references; and, on a card, each CUDA kernel against its plain version.
JAX is imported inside the tests that use it, so the ``cuda``-marked
tests also run where there is a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_kernels.py

Contracts: flash_attention rtol/atol 1e-5 on f32 inputs (exp and
summation order); on bf16 outputs each element within 2 bf16 ulps of the
reference element plus 1e-5 (one f32 result rounded once to bf16 on
each side: one ulp apart at a rounding boundary, the second ulp margin,
the atol for elements near zero), a limit that variants rounding p or the
PV accumulator to bf16 miss; ssd_scan rtol/atol 1e-4 (exp and summation
order of an f32 recurrence).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    bf16_limit_share, flash_attention, flash_attention_ref)
from repro_torch.kernels.ssd_scan import (ssd_chunked, ssd_scan,  # noqa: E402
                                          ssd_scan_ref)

F32_TOL = 1e-5
SSD_TOL = 1e-4


def qkv(B, S, Hq, Hkv, D, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def ssd_inputs(B, S, H, P, N, seed):
    r = np.random.default_rng(seed)
    return [(r.standard_normal((B, S, H, P)) * 0.5).astype(np.float32),
            (r.standard_normal((B, S, N)) * 0.5).astype(np.float32),
            (r.standard_normal((B, S, N)) * 0.5).astype(np.float32),
            r.uniform(0.01, 0.2, (B, S, H)).astype(np.float32),
            r.uniform(-1, 0.5, (H,)).astype(np.float32)]


def jax_side():
    """The JAX package's kernels and references (skips where JAX is not
    installed, as on the card's machine)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention import ops as fa_ops
    from repro.kernels.flash_attention.ref import attention as fa_ref
    from repro.kernels.ssd_scan import ops as ssd_ops
    return jnp, fa_ops, fa_ref, ssd_ops


def as_np(a):
    return np.asarray(a, np.float32)


def assert_flash_close(got, ref, dtype):
    """The flash contract: rtol/atol 1e-5 on f32, the per-element bf16
    ulp limit (``bf16_limit_share`` at most 1) on bf16."""
    got, ref = (a.float() if torch.is_tensor(a) else torch.tensor(np.array(a))
                for a in (got, ref))
    if dtype == "float32":
        torch.testing.assert_close(got, ref, rtol=F32_TOL, atol=F32_TOL)
    else:
        share = bf16_limit_share(got, ref)
        assert share <= 1.0, f"{share:.3g} of the bf16 limit"


def attention_low_precision(q, k, v, round_p, round_acc, tile=64):
    """Causal attention that rounds the probabilities p (``round_p``) or
    the PV accumulator after each ``tile`` of keys (``round_acc``) to
    bf16: the lower-precision variants the bf16 limit must reject."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.float().reshape(B, S, Hkv, Hq // Hkv, D),
                     k.float()) / D ** 0.5
    s = s.masked_fill(~torch.ones((S, S), dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    pv = p.bfloat16().float() if round_p else p
    acc = 0
    for t in range(0, S, tile):
        acc = acc + torch.einsum("bhgqk,bkhd->bhgqd", pv[..., t:t + tile],
                                 v[:, t:t + tile].float())
        if round_acc:
            acc = acc.bfloat16().float()
    o = acc / p.sum(-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


# --- flash_attention --------------------------------------------------------
@pytest.mark.parametrize(
    "B,S,Hq,Hkv,D,causal,dtype",
    [(2, 128, 4, 4, 64, True, "float32"),
     (2, 256, 8, 2, 64, True, "bfloat16"),
     (1, 256, 15, 5, 64, True, "float32"),     # smollm GQA 15/5
     (2, 128, 4, 1, 128, True, "bfloat16"),    # MQA
     (2, 128, 4, 4, 64, False, "float32"),
     (1, 512, 2, 2, 32, True, "float32"),
     (1, 128, 4, 2, 128, True, "float32"),     # qwen/phi4 head dim
     (2, 128, 4, 2, 128, True, "bfloat16"),
     (1, 128, 8, 1, 256, True, "bfloat16")])   # paligemma: MQA, D 256
def test_flash_matches_jax_interpret_and_ref(B, S, Hq, Hkv, D, causal, dtype):
    jnp, jfa_ops, jfa_ref, _ = jax_side()
    q, k, v = qkv(B, S, Hq, Hkv, D, seed=S + Hq + D)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    o_int = as_np(jfa_ops.flash_attention(jq, jk, jv, causal))
    o_ref = as_np(jfa_ref(jq, jk, jv, causal=causal))
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.tensor(a).to(td) for a in (q, k, v))
    o_t = flash_attention(tq, tk, tv, causal=causal)
    assert o_t.dtype == td and o_t.shape == (B, S, Hq, D)
    for o_j in (o_int, o_ref):
        assert_flash_close(o_t, o_j, dtype)


@pytest.mark.parametrize("round_p,round_acc", [(True, False), (False, True)],
                         ids=["bf16-p", "bf16-accumulator"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(2, 256, 8, 2, 64),
                                          (1, 512, 4, 4, 64)])
def test_flash_bf16_limit_rejects_lower_precision(B, S, Hq, Hkv, D, round_p,
                                                  round_acc):
    """The bf16 limit has teeth: the same attention with p or the PV
    accumulator rounded to bf16 misses it, while the f32 plain version
    meets it against the JAX package's f32 oracle."""
    jnp, _, jfa_ref, _ = jax_side()
    q, k, v = (torch.tensor(a).bfloat16()
               for a in qkv(B, S, Hq, Hkv, D, seed=S + Hq + D))
    ref = as_np(jfa_ref(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                          for a in (q, k, v))))
    assert_flash_close(flash_attention(q, k, v), ref, "bfloat16")
    low = attention_low_precision(q, k, v, round_p, round_acc)
    assert bf16_limit_share(low, torch.tensor(ref)) > 1.0


def test_flash_wrapper_on_cpu_is_the_plain_version():
    q, k, v = (torch.tensor(a) for a in qkv(1, 64, 4, 2, 32, seed=3))
    before = LAUNCHES["flash_attention"]
    o_w = flash_attention(q, k, v)
    assert LAUNCHES["flash_attention"] == before   # no kernel on the CPU
    assert torch.equal(o_w, flash_attention_ref(q, k, v))


def test_flash_causality():
    """Changing future K/V must not change past outputs."""
    q, k, v = (torch.tensor(a) for a in qkv(1, 128, 2, 2, 32, seed=4))
    o1 = flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 64:], v2[:, 64:] = 99.0, -99.0
    o2 = flash_attention(q, k2, v2)
    assert torch.equal(o1[:, :64], o2[:, :64])


# --- ssd_scan ---------------------------------------------------------------
@pytest.mark.parametrize(
    "B,S,H,P,N,Q",
    [(2, 64, 4, 32, 16, 16), (1, 128, 2, 64, 32, 32),
     (2, 256, 4, 64, 128, 64), (1, 64, 8, 16, 8, 64),
     (1, 96, 2, 32, 16, 32)])
def test_ssd_matches_jax_interpret(B, S, H, P, N, Q):
    jnp, _, _, jssd_ops = jax_side()
    ins = ssd_inputs(B, S, H, P, N, seed=S + H + N)
    y_j, h_j = jssd_ops.ssd_chunked(*(jnp.asarray(a) for a in ins), Q)
    y_t, h_t = ssd_scan(*(torch.tensor(a) for a in ins), Q)
    assert y_t.dtype == torch.float32 and h_t.shape == (B, H, P, N)
    np.testing.assert_allclose(y_t.numpy(), as_np(y_j), rtol=SSD_TOL,
                               atol=SSD_TOL)
    np.testing.assert_allclose(h_t.numpy(), as_np(h_j), rtol=SSD_TOL,
                               atol=SSD_TOL)


def test_ssd_ragged_sequence_is_the_zero_padded_one():
    """S % Q != 0 (which the TPU kernel asserts away): the plain version
    equals the JAX kernel on the zero-padded sequence, trimmed."""
    jnp, _, _, jssd_ops = jax_side()
    B, S, H, P, N, Q = 1, 40, 2, 16, 8, 16
    ins = ssd_inputs(B, S, H, P, N, seed=5)
    pad = lambda a: np.pad(a, [(0, 0), (0, 8)] + [(0, 0)] * (a.ndim - 2))
    padded = [pad(a) for a in ins[:4]] + [ins[4]]
    y_j, h_j = jssd_ops.ssd_chunked(*(jnp.asarray(a) for a in padded), Q)
    y_t, h_t = ssd_scan(*(torch.tensor(a) for a in ins), Q)
    np.testing.assert_allclose(y_t.numpy(), as_np(y_j)[:, :S],
                               rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(h_t.numpy(), as_np(h_j), rtol=SSD_TOL,
                               atol=SSD_TOL)


def test_ssd_with_state_goes_to_the_model_reference():
    """A carried-in h0 takes the model's ssd_chunked_ref in both packages
    (bf16-rounded einsum operands, f32 results)."""
    jnp, _, _, jssd_ops = jax_side()
    B, S, H, P, N, Q = 1, 32, 2, 16, 8, 16
    ins = ssd_inputs(B, S, H, P, N, seed=6)
    h0 = np.random.default_rng(7).standard_normal((B, H, P, N)).astype(
        np.float32)
    y_j, h_j = jssd_ops.ssd_chunked(*(jnp.asarray(a) for a in ins), Q,
                                    h0=jnp.asarray(h0))
    before = LAUNCHES["ssd_scan"]
    y_t, h_t = ssd_chunked(*(torch.tensor(a) for a in ins), Q,
                           h0=torch.tensor(h0))
    assert LAUNCHES["ssd_scan"] == before
    np.testing.assert_allclose(y_t.numpy(), as_np(y_j), rtol=SSD_TOL,
                               atol=SSD_TOL)
    np.testing.assert_allclose(h_t.numpy(), as_np(h_j), rtol=SSD_TOL,
                               atol=SSD_TOL)


def test_ssd_wrapper_on_cpu_is_the_plain_version():
    ins = [torch.tensor(a) for a in ssd_inputs(2, 48, 2, 16, 8, seed=8)]
    before = LAUNCHES["ssd_scan"]
    y_w, h_w = ssd_scan(*ins, 16)
    y_p, h_p = ssd_scan_ref(*ins, 16)
    assert LAUNCHES["ssd_scan"] == before
    assert torch.equal(y_w, y_p) and torch.equal(h_w, h_p)


# --- on the card ------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_flash_attention_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "interpreter (chip_smoke.py runs this check on the card)")
    dev = torch.device("cuda")
    for B, S, Hq, Hkv, D, causal, dtype in [
            (2, 200, 4, 4, 64, True, "float32"),      # ragged last tile
            (1, 256, 15, 5, 64, True, "bfloat16"),
            (2, 128, 4, 1, 128, False, "float32"),
            (1, 40, 4, 2, 16, True, "bfloat16"),
            # chip_smoke.py's phase 3 shapes: zamba2-1.2b, qwen2.5-3b GQA,
            # a ragged S on the tensor-core variant, D 32 on the FP32 one
            (4, 2048, 32, 32, 64, True, "bfloat16"),
            (4, 2048, 16, 2, 128, True, "bfloat16"),
            (2, 40, 8, 1, 64, True, "float32"),
            (1, 1000, 4, 4, 64, True, "bfloat16"),
            (2, 256, 4, 2, 32, True, "bfloat16"),
            # D 256 (paligemma-3b's MQA): ragged, full and f32
            (2, 300, 8, 1, 256, True, "bfloat16"),
            (1, 128, 2, 2, 256, False, "float32")]:
        td = getattr(torch, dtype)
        q, k, v = (torch.tensor(a, device=dev).to(td)
                   for a in qkv(B, S, Hq, Hkv, D, seed=S))
        before = LAUNCHES["flash_attention"]
        o_k = flash_attention(q, k, v, causal=causal)
        assert LAUNCHES["flash_attention"] == before + 1
        o_p = flash_attention_ref(q, k, v, causal=causal)
        assert_flash_close(o_k.cpu(), o_p.cpu(), dtype)


@pytest.mark.cuda
def test_cuda_ssd_scan_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "interpreter (chip_smoke.py runs this check on the card)")
    dev = torch.device("cuda")
    for B, S, H, P, N, Q in [(2, 64, 4, 32, 16, 16), (2, 256, 4, 64, 128, 64),
                             (1, 300, 2, 64, 64, 256),   # ragged chunk
                             (1, 96, 2, 32, 16, 32),
                             # chip_smoke.py's phase 3 shapes: zamba2-1.2b,
                             # mamba2-1.3b and one ragged chunk
                             (4, 2048, 64, 64, 64, 256),
                             (4, 2048, 64, 64, 128, 256),
                             (1, 100, 4, 32, 16, 256)]:
        ins = [torch.tensor(a, device=dev)
               for a in ssd_inputs(B, S, H, P, N, seed=S)]
        before = LAUNCHES["ssd_scan"]
        y_k, h_k = ssd_scan(*ins, Q)
        assert LAUNCHES["ssd_scan"] == before + 1
        y_p, h_p = ssd_scan_ref(*ins, Q)
        torch.testing.assert_close(y_k, y_p, rtol=SSD_TOL, atol=SSD_TOL)
        torch.testing.assert_close(h_k, h_p, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_one_tile(D, causal):
    """One 64-row tile, one head: the tensor-core variant's S accumulator
    fragment must land in P.V's A-operand fragment row for row and
    column for column, or this output is wrong."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "interpreter (chip_smoke.py runs this check on the card)")
    from repro_torch.kernels.flash_attention import variant
    assert variant(torch.bfloat16, D) == "wgmma"
    q, k, v = (torch.tensor(a, device="cuda").bfloat16()
               for a in qkv(1, 64, 1, 1, D, seed=D))
    o_k = flash_attention(q, k, v, causal=causal)
    o_p = flash_attention_ref(q, k, v, causal=causal)
    assert_flash_close(o_k.cpu(), o_p.cpu(), "bfloat16")
