"""Mamba2 SSD chunk scan: wrapper and plain version.

The wrapper launches ``csrc/ssd_scan.cu`` (see the note at the top of that
file) on CUDA tensors and runs the plain version, :func:`ssd_scan_ref`, on
CPU tensors.  The plain version repeats the TPU kernel's f32 chunk
recurrence; it is not the model's ``ssd_chunked_ref``, whose einsums round
their operands to bf16.  Contract against the plain version: rtol/atol
1e-4 (exp and summation order).

The kernel computes the forward only, and the raw wrapper refuses an
input that requires grad (``kernels.check_no_grad``).  The model trains
through :class:`SSDScanFn`, whose backward recomputes the model's
reference ``ssd_chunked_ref``, as the JAX package's ``custom_vjp`` op
does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (LAUNCHES, check_cuda_tensor, check_no_grad,
                                 meta_stand_in)

MAX_HEAD_DIM = 64   # P: one 64-column output tile per thread block
MAX_CHUNK = 256     # Q: at most four 64-row q tiles per chunk
# cum, C.B^T, chunk states, state passing, output
CUDA_LAUNCHES_PER_CALL = 5
F32 = torch.float32


def ssd_scan_ref(xs, Bm, Cm, dt, A_log, Q: int = 256):
    """The plain version.  xs [B,S,H,P], Bm/Cm [B,S,N], dt [B,S,H],
    A_log [H] -> (y [B,S,H,P] in ``xs.dtype``, h_final [B,H,P,N] f32).
    A sequence that is not a multiple of the chunk is zero-padded (dt = 0:
    decay 1, update 0)."""
    B, S, H, P = xs.shape
    N = Bm.shape[-1]
    Q = min(Q, S)
    pad = -S % Q
    zpad = lambda a: torch.nn.functional.pad(
        a.to(F32), (0, 0) * (a.dim() - 2) + (0, pad))
    xs_, B_, C_, dt_ = zpad(xs), zpad(Bm), zpad(Cm), zpad(dt)
    Cn = (S + pad) // Q
    A = -torch.exp(A_log.to(F32))                             # [H]
    cum = torch.cumsum((A * dt_).reshape(B, Cn, Q, H), dim=2)
    x_c = xs_.reshape(B, Cn, Q, H, P)
    B_c, C_c = B_.reshape(B, Cn, Q, N), C_.reshape(B, Cn, Q, N)
    dt_c = dt_.reshape(B, Cn, Q, H)

    # intra-chunk: M = (C.B^T) * exp(cum_q - cum_s) * dt_s, masked to s <= q
    G = torch.einsum("bcqn,bcsn->bcqs", C_c, B_c)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # [B,Cn,Q,Q,H]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xs.device).tril()
    L = torch.where(causal[None, None, :, :, None], torch.exp(decay),
                    torch.zeros((), dtype=F32, device=xs.device))
    M = G[..., None] * L * dt_c[:, :, None, :, :]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", M, x_c)

    total = cum[:, :, -1]                                     # [B,Cn,H]
    wB = ((torch.exp(total[:, :, None] - cum) * dt_c)[..., None]
          * B_c[:, :, :, None, :])                            # [B,Cn,Q,H,N]
    upd = torch.einsum("bcshp,bcshn->bchpn", x_c, wB)

    h = torch.zeros((B, H, P, N), dtype=F32, device=xs.device)
    ys = []
    for c in range(Cn):
        ch = torch.einsum("bqn,bhpn->bqhp", C_c[:, c], h)
        ys.append(y_intra[:, c] + torch.exp(cum[:, c])[..., None] * ch)
        h = torch.exp(total[:, c])[:, :, None, None] * h + upd[:, c]
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(xs.dtype), h


def _lib():
    from repro_torch.kernels import _build
    fn = _build.load("ssd_scan").ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan(xs, Bm, Cm, dt, A_log, Q: int = 256):
    """SSD chunk scan from a zero state.  CPU tensors run
    :func:`ssd_scan_ref`; CUDA tensors launch the kernel's passes on the
    current stream (all f32 and contiguous, P <= ``MAX_HEAD_DIM``, P and N
    multiples of 4, chunk Q <= ``MAX_CHUNK``), with their scratch allocated
    here."""
    if xs.device.type == "cpu":
        return ssd_scan_ref(xs, Bm, Cm, dt, A_log, Q)
    check_no_grad("ssd_scan", xs=xs, Bm=Bm, Cm=Cm, dt=dt, A_log=A_log)
    B, S, H, P = xs.shape
    N = Bm.shape[-1]
    Q = min(Q, S)
    if P > MAX_HEAD_DIM or P % 4 or N % 4 or Q > MAX_CHUNK:
        raise ValueError(f"ssd_scan takes P <= {MAX_HEAD_DIM}, P and N "
                         f"multiples of 4 and Q <= {MAX_CHUNK}, got P={P}, "
                         f"N={N}, Q={Q}")
    if xs.device.type == "meta":
        return meta_stand_in("ssd_scan", ssd_scan_ref, xs, Bm, Cm, dt, A_log,
                             Q)
    check_cuda_tensor("xs", xs, F32, (B, S, H, P))
    check_cuda_tensor("Bm", Bm, F32, (B, S, N))
    check_cuda_tensor("Cm", Cm, F32, (B, S, N))
    check_cuda_tensor("dt", dt, F32, (B, S, H))
    check_cuda_tensor("A_log", A_log, F32, (H,))
    y = torch.empty_like(xs)
    h = torch.empty((B, H, P, N), dtype=F32, device=xs.device)
    # the passes' scratch: cum [B,Cn,H,Qp], C.B^T [B,Cn,Qp,Qp] and the
    # chunk states [B,Cn,H,P,N], Cn chunks of Qp = Q rounded up to 64
    Cn, Qp = -(-S // Q), -(-Q // 64) * 64
    scratch = torch.empty(B * Cn * (H * Qp + Qp * Qp + H * P * N),
                          dtype=F32, device=xs.device)
    err = _lib()(xs.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
                 A_log.data_ptr(), y.data_ptr(), h.data_ptr(),
                 scratch.data_ptr(), B, S, H, P, N, Q,
                 torch.cuda.current_stream(xs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch at N={N}, Q={Q} failed: CUDA "
                           f"error {err}")
    LAUNCHES["ssd_scan"] += 1
    return y, h


class SSDScanFn(torch.autograd.Function):
    """:func:`ssd_scan` with a backward, the counterpart of the JAX
    package's ``custom_vjp`` op (``repro/kernels/ssd_scan/ops.py``): the
    forward is the wrapper (the kernel on CUDA tensors, the plain version
    on CPU ones); the backward recomputes the model's reference
    ``models.ssm.ssd_chunked_ref`` from the saved inputs and returns its
    VJP to all five of xs, Bm, Cm, dt and A_log.  An output nobody used
    (h_final, in the model) brings no gradient and is left out of it.
    ``SSDScanFn.apply(xs, Bm, Cm, dt, A_log, Q) -> (y, h_final)``."""

    @staticmethod
    def forward(ctx, xs, Bm, Cm, dt, A_log, Q=256):
        ctx.save_for_backward(xs, Bm, Cm, dt, A_log)
        ctx.Q = Q
        ctx.set_materialize_grads(False)
        return ssd_scan(xs.contiguous(), Bm.contiguous(), Cm.contiguous(),
                        dt.contiguous(), A_log.contiguous(), Q)

    @staticmethod
    def backward(ctx, gy, gh):
        from repro_torch.models.ssm import ssd_chunked_ref
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            outs, gouts = zip(*[(o, g) for o, g in zip(
                ssd_chunked_ref(*ins, ctx.Q), (gy, gh)) if g is not None])
            grads = torch.autograd.grad(outs, ins, gouts)
        return (*grads, None)


def ssd_chunked(xs, Bm, Cm, dt, A_log, Q: int = 256, h0=None):
    """The model's kernel-backed SSD, as the JAX package's
    ``ssd_scan/ops.ssd_chunked``: a carried-in state ``h0`` goes to the
    model's reference ``ssd_chunked_ref``; the zero-state prefill and the
    training forward, the hot path, go to :class:`SSDScanFn`."""
    if h0 is not None:
        from repro_torch.models.ssm import ssd_chunked_ref
        return ssd_chunked_ref(xs, Bm, Cm, dt, A_log, Q, h0=h0)
    return SSDScanFn.apply(xs, Bm, Cm, dt, A_log, Q)
