"""Mamba2 SSD (state-space duality, arXiv:2405.21060) — chunked form.

The PyTorch counterpart of the JAX package's ``models/ssm.py``.  The
sequence is split into chunks of length Q; within a chunk the quadratic
"attention-like" dual form runs as einsums, across chunks a small
recurrence carries the SSM state h [B, H, P, N].  Decode is the O(1)
recurrent update.

    h_t = a_t * h_{t-1} + dt_t * B_t ⊗ x_t          a_t = exp(-exp(A_log)*dt_t)
    y_t = C_t · h_t + D * x_t

``ssd_chunked_ref`` is the model's reference (its einsums take operands
rounded to bf16, with f32 results, as the JAX reference does);
``impl='kernel'`` routes the chunk scan through ``repro_torch/kernels/
ssd_scan``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from repro_torch.models.config import IMPLS
from repro_torch.models.layers import BF16, F32, init_dense, rmsnorm


def _bf(a: torch.Tensor) -> torch.Tensor:
    """An einsum operand as the JAX code gives it: rounded to bf16, then
    contracted in f32 (``preferred_element_type=F32``)."""
    return a.to(BF16).to(F32)


def init_ssm(gen, cfg, device=None):
    d, di, st, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    conv_ch = di + 2 * st
    z = lambda *shape: torch.zeros(shape, dtype=F32, device=device)
    return {
        "in_proj": init_dense(gen, d, 2 * di + 2 * st + H, device=device),
        "conv_w": torch.randn((cfg.conv_width, conv_ch), generator=gen,
                              dtype=F32, device=device) * 0.1,
        "conv_b": z(conv_ch),
        "A_log": z(H),                            # A = -exp(A_log) = -1
        "D": torch.ones((H,), dtype=F32, device=device),
        "dt_bias": z(H),
        "norm_w": torch.ones((di,), dtype=F32, device=device),
        "out_proj": init_dense(gen, di, d, device=device),
    }


def _split_proj(params, x, cfg):
    """in_proj -> gate z [.., di], conv channels (xs, B, C), dt [.., H]."""
    di, st = cfg.d_inner, cfg.ssm_state
    zxbcdt = (x.to(BF16) @ params["in_proj"].to(BF16)).to(F32)
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * st]
    dt_raw = zxbcdt[..., di + di + 2 * st:]
    dt = tF.softplus(dt_raw + params["dt_bias"])
    return z, xBC, dt


def _causal_conv(params, xBC, cfg, conv_state=None):
    """Depthwise causal conv over the (xs|B|C) channels.

    train/prefill: conv_state None, pads with zeros on the left.
    decode: conv_state [B, W-1, ch] holds the trailing context; returns the
    rolled state.  The taps are summed in the JAX code's order (Python's
    ``sum`` from 0 over i).
    """
    W = cfg.conv_width
    if conv_state is None:
        pad = torch.zeros(xBC.shape[:1] + (W - 1,) + xBC.shape[2:],
                          dtype=xBC.dtype, device=xBC.device)
        ctx = torch.cat([pad, xBC], dim=1)
    else:
        ctx = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    # a copy: a view would keep the whole [B, S+W-1, ch] context alive in
    # the prefill cache (5 GB over zamba2-1.2b's 38 layers at S = 2048)
    new_state = ctx[:, -(W - 1):].clone()
    S = xBC.shape[1]
    out = sum(ctx[:, i:i + S] * params["conv_w"][i] for i in range(W))
    return tF.silu(out + params["conv_b"]), new_state


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum`` along ``dim``, except on a CUDA tensor in
    deterministic mode, where ``torch.cumsum`` has no deterministic
    implementation and raises: there, an inclusive scan of log2(n) shifted
    adds (Hillis-Steele), whose order is fixed and whose backward is the
    same adds in reverse."""
    if x.device.type != "cuda" or \
            not torch.are_deterministic_algorithms_enabled():
        return torch.cumsum(x, dim)
    n, shift = x.shape[dim], 1
    while shift < n:
        zeros = torch.zeros_like(x.narrow(dim, 0, shift))
        x = x + torch.cat([zeros, x.narrow(dim, 0, n - shift)], dim)
        shift *= 2
    return x


def ssd_chunked_ref(xs, Bm, Cm, dt, A_log, Q: int, h0=None):
    """Chunked SSD.  xs [B,S,H,P], Bm/Cm [B,S,N], dt [B,S,H], A_log [H].

    Returns (y [B,S,H,P] f32, h_final [B,H,P,N] f32).  Sequences not
    divisible by the chunk are zero-padded (dt=0 => decay 1, update 0: a
    no-op suffix).
    """
    B, S, H, Pd = xs.shape
    N = Bm.shape[-1]
    Q = min(Q, S)
    if S % Q:
        pad = Q - S % Q
        zpad = lambda a: tF.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        y, h = ssd_chunked_ref(zpad(xs), zpad(Bm), zpad(Cm), zpad(dt),
                               A_log, Q, h0=h0)
        return y[:, :S], h
    Cn = S // Q

    a_log = -torch.exp(A_log)[None, None] * dt                # [B,S,H] (<=0)
    xs_c = xs.reshape(B, Cn, Q, H, Pd)
    B_c = Bm.reshape(B, Cn, Q, N)
    C_c = Cm.reshape(B, Cn, Q, N)
    dt_c = dt.reshape(B, Cn, Q, H)
    al_c = a_log.reshape(B, Cn, Q, H)
    cum = _cumsum(al_c, dim=2)                                # [B,Cn,Q,H]

    # ---- intra-chunk quadratic (dual) term --------------------------------
    G = torch.einsum("bcqn,bcsn->bcqs", _bf(C_c), _bf(B_c))    # [B,Cn,Q,Q]
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # [B,Cn,Q,S,H]
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=xs.device).tril()[None, None, :, :, None]
    # exp of the masked decay: above the diagonal the decay is positive,
    # and where it passes ~88 exp overflows to inf, whose VJP through the
    # where is 0 * inf = NaN (the JAX reference's gradient, at a chunk
    # whose decays spread that far: zamba2-1.2b at its published Q = 256)
    zero = torch.zeros((), dtype=F32, device=xs.device)
    L = torch.where(causal, torch.exp(torch.where(causal, decay, zero)),
                    zero)
    M = G[..., None] * L * dt_c[:, :, None, :, :]             # [B,Cn,Q,Q,H]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", _bf(M), _bf(xs_c))

    # ---- chunk states + inter-chunk recurrence ----------------------------
    total = cum[:, :, -1:, :]                                 # [B,Cn,1,H]
    w_state = torch.exp(total - cum) * dt_c                   # [B,Cn,Q,H]
    S_c = torch.einsum("bcsn,bcsh,bcshp->bchpn", _bf(B_c), _bf(w_state),
                       _bf(xs_c))                             # [B,Cn,H,P,N]
    chunk_decay = torch.exp(total[:, :, 0, :])                # [B,Cn,H]

    h = (torch.zeros((B, H, Pd, N), dtype=F32, device=xs.device)
         if h0 is None else h0.to(F32))
    h_prevs = []
    for c in range(Cn):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                     # [B,Cn,H,P,N]

    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", _bf(C_c),
                           _bf(torch.exp(cum)), _bf(h_prevs))
    y = (y_intra + y_inter).reshape(B, S, H, Pd)
    return y, h


def ssm_block(params, x, cfg, mode: str = "train", state=None,
              impl: str = "ref"):
    """Full Mamba2 block.  state = (h [B,H,P,N], conv [B,W-1,ch]) for decode.

    Returns (out [B,S,d], new_state).
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    B, S, d = x.shape
    di, st, H, Pd = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                     cfg.ssm_head_dim)
    z, xBC, dt = _split_proj(params, x, cfg)

    h0 = conv_state = None
    if state is not None:
        h0, conv_state = state
    xBC, new_conv = _causal_conv(params, xBC, cfg, conv_state)
    xs = xBC[..., :di].reshape(B, S, H, Pd)
    Bm = xBC[..., di:di + st]
    Cm = xBC[..., di + st:]

    if mode == "decode" and S == 1:
        # O(1) recurrent step
        a = torch.exp(-torch.exp(params["A_log"])[None, None] * dt)  # [B,1,H]
        h = (h0.to(F32) if h0 is not None
             else torch.zeros((B, H, Pd, st), dtype=F32, device=x.device))
        upd = torch.einsum("bn,bh,bhp->bhpn", Bm[:, 0], dt[:, 0], xs[:, 0])
        h = a[:, 0, :, None, None] * h + upd
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], h)[:, None]  # [B,1,H,P]
        h_fin = h
    elif impl == "kernel":
        from repro_torch.kernels.ssd_scan import ssd_chunked
        y, h_fin = ssd_chunked(xs, Bm, Cm, dt, params["A_log"],
                               cfg.ssm_chunk, h0=h0)
    else:
        y, h_fin = ssd_chunked_ref(xs, Bm, Cm, dt, params["A_log"],
                                   cfg.ssm_chunk, h0=h0)

    y = y + params["D"][None, None, :, None] * xs
    y = y.reshape(B, S, di)
    y = y * tF.silu(z)
    y = rmsnorm(y.to(x.dtype), params["norm_w"], cfg.norm_eps)
    out = (y.to(BF16) @ params["out_proj"].to(BF16)).to(x.dtype)
    return out, (h_fin, new_conv)
