"""The arithmetic of the port's tensor-core kernels, emulated on the CPU
and held to the kernels' contracts against their plain versions.

The CUDA kernels run only on a card; these emulations repeat the
rounding schemes they use, so the schemes are pinned where there is no
card:

* ``flash_attention`` (bf16): scores from bf16 operands in f32, the TPU
  kernel's online softmax over 64-key tiles, and P.V with p split into
  two bf16 parts, p_hi = bf16(p) and p_lo = bf16(p - p_hi), both
  multiplied into an f32 accumulator.  It must stay within
  ``bf16_limit_share`` <= 1 of ``flash_attention_ref``; the same attention
  with p rounded once, to TF32 or to bf16, must not.
* ``ssd_scan`` (f32): every product a.b of the chunk passes as three
  passes over split operands, a_lo b_hi + a_hi b_lo + a_hi b_hi, with
  a = a_hi + a_lo in bf16 (the kernel's scheme) or TF32.  Both must stay
  within rtol/atol 1e-4 of ``ssd_scan_ref``; one TF32 pass must not.

TF32 rounding is round-to-nearest onto 10 stored mantissa bits, on the
int32 view: ``(bits + 0x1000) & ~0x1FFF``.
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.kernels.flash_attention import (  # noqa: E402
    bf16_limit_share, flash_attention_ref)
from repro_torch.kernels.ssd_scan import ssd_scan_ref  # noqa: E402

SSD_TOL = 1e-4
F32 = torch.float32


def tf32(x):
    """Round f32 to TF32 (10 stored mantissa bits), to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(F32)


def bf16(x):
    return x.bfloat16().float()


def split(x, rnd):
    hi = rnd(x)
    return hi, rnd(x - hi)


def mm_split(a, b, rnd):
    """a @ b as the kernels' three passes over split operands."""
    (ah, al), (bh, bl) = split(a, rnd), split(b, rnd)
    return al @ bh + ah @ bl + ah @ bh


def mm_one(a, b, rnd):
    """a @ b in one pass over rounded operands."""
    return rnd(a) @ rnd(b)


# --- flash_attention --------------------------------------------------------
def flash_emulated(q, k, v, p_mode, tile=64):
    """Causal attention as the bf16 tensor-core kernel computes it, with
    p entering P.V as ``p_mode``: 'split' (p_hi + p_lo, both bf16), 'tf32'
    or 'bf16' (p rounded once)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]     # [B,Hkv,1,S,D]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    m = torch.full((B, Hkv, G, S, 1), -1e30)
    l = torch.zeros((B, Hkv, G, S, 1))
    acc = torch.zeros((B, Hkv, G, S, D))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        s = (qf @ kf[..., k0:k0 + tile, :].transpose(-1, -2)) * scale
        kpos = torch.arange(k0, min(k0 + tile, S))[None, :]
        s = s.masked_fill(kpos > qpos, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        vt = vf[..., k0:k0 + tile, :]
        if p_mode == "split":
            p_hi, p_lo = split(p, bf16)
            pv = p_hi @ vt + p_lo @ vt
        else:
            pv = (tf32(p) if p_mode == "tf32" else bf16(p)) @ vt
        acc = acc * alpha + pv
        m = m_new
    o = acc / l.clamp_min(1e-20)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).bfloat16()


def qkv_bf16(B, S, Hq, Hkv, D, seed):
    r = np.random.default_rng(seed)
    return [torch.tensor(r.standard_normal(s), dtype=F32).bfloat16()
            for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]


FLASH_SHAPES = [(2, 256, 8, 2, 64), (1, 256, 4, 2, 128)]


@pytest.mark.parametrize("B,S,Hq,Hkv,D", FLASH_SHAPES)
def test_flash_split_p_meets_the_bf16_limit(B, S, Hq, Hkv, D):
    q, k, v = qkv_bf16(B, S, Hq, Hkv, D, seed=S + D)
    share = bf16_limit_share(flash_emulated(q, k, v, "split"),
                             flash_attention_ref(q, k, v))
    assert share <= 1.0, f"{share:.3g} of the bf16 limit"


@pytest.mark.parametrize("p_mode", ["tf32", "bf16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", FLASH_SHAPES)
def test_flash_one_pass_p_misses_the_bf16_limit(B, S, Hq, Hkv, D, p_mode):
    q, k, v = qkv_bf16(B, S, Hq, Hkv, D, seed=S + D)
    share = bf16_limit_share(flash_emulated(q, k, v, p_mode),
                             flash_attention_ref(q, k, v))
    assert share > 1.0, f"p in {p_mode}: only {share:.3g} of the limit"


# --- ssd_scan ---------------------------------------------------------------
def ssd_emulated(xs, Bm, Cm, dt, A_log, Q, mm):
    """The kernel's chunk passes, every product through ``mm``: G = C.B^T
    per (b, chunk); per head the chunk state xs^T (w B), the state passed
    over the chunks, then y = (exp(cum_q) C_q) . h_prev^T + (G o L o dt)
    . xs.  S must be a multiple of Q."""
    B, S, H, P = xs.shape
    N = Bm.shape[-1]
    Cn = S // Q
    A = -torch.exp(A_log)
    y = torch.empty_like(xs)
    h_out = torch.empty((B, H, P, N))
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    for b in range(B):
        h = torch.zeros((H, P, N))
        for c in range(Cn):
            rows = slice(c * Q, (c + 1) * Q)
            Cc, Bc = Cm[b, rows], Bm[b, rows]
            G = mm(Cc, Bc.T)
            for hh in range(H):
                x, d = xs[b, rows, hh], dt[b, rows, hh]
                cum = torch.cumsum(A[hh] * d, 0)
                L = torch.where(causal, torch.exp(cum[:, None] - cum[None]),
                                torch.zeros(()))
                M = G * L * d[None]
                y_off = mm(torch.exp(cum)[:, None] * Cc, h[hh].T)
                y[b, rows, hh] = y_off + mm(M, x)
                w = torch.exp(cum[-1] - cum) * d
                upd = mm(x.T, w[:, None] * Bc)
                h[hh] = torch.exp(cum[-1]) * h[hh] + upd
        h_out[b] = h
    return y, h_out


def ssd_inputs(B, S, H, P, N, seed):
    r = np.random.default_rng(seed)
    f = lambda a: torch.tensor(a, dtype=F32)
    return (f(r.standard_normal((B, S, H, P)) * 0.5),
            f(r.standard_normal((B, S, N)) * 0.5),
            f(r.standard_normal((B, S, N)) * 0.5),
            f(r.uniform(0.01, 0.2, (B, S, H))), f(r.uniform(-1, 0.5, H)))


SSD_SHAPES = [(1, 128, 4, 64, 64, 64),     # two chunks of Q = 64
              (1, 128, 2, 64, 128, 64)]    # N = 128


def ssd_share(got, ref):
    """Largest |got - ref| as a share of rtol |ref| + atol, both 1e-4."""
    return ((got - ref).abs() / (SSD_TOL + SSD_TOL * ref.abs())).max().item()


@pytest.mark.parametrize("scheme", ["3xbf16", "3xtf32"])
@pytest.mark.parametrize("B,S,H,P,N,Q", SSD_SHAPES)
def test_ssd_split_products_meet_the_f32_contract(B, S, H, P, N, Q, scheme):
    ins = ssd_inputs(B, S, H, P, N, seed=S + N)
    rnd = bf16 if scheme == "3xbf16" else tf32
    y, h = ssd_emulated(*ins, Q, lambda a, b: mm_split(a, b, rnd))
    y_ref, h_ref = ssd_scan_ref(*ins, Q)
    torch.testing.assert_close(y, y_ref, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(h, h_ref, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.parametrize("B,S,H,P,N,Q", SSD_SHAPES)
def test_ssd_one_tf32_pass_misses_the_f32_contract(B, S, H, P, N, Q):
    ins = ssd_inputs(B, S, H, P, N, seed=S + N)
    y, h = ssd_emulated(*ins, Q, lambda a, b: mm_one(a, b, tf32))
    y_ref, h_ref = ssd_scan_ref(*ins, Q)
    assert max(ssd_share(y, y_ref), ssd_share(h, h_ref)) > 1.0


def test_tf32_rounds_to_nearest_on_ten_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      1.0 + 2 ** -12, -(1.0 + 3 * 2 ** -12)], dtype=F32)
    want = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -9, 1.0,
                         -(1.0 + 2 ** -10)], dtype=F32)
    assert torch.equal(tf32(x), want)
