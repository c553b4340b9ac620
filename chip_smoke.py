"""On-card smoke test of the PyTorch port (repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order, each of which fails the script when it fails:
  1. build the four CUDA kernels from src/repro_torch/kernels/csrc/ (one
     nvcc per source, started together) and print ptxas's registers,
     static shared memory and spills for the two LM kernels' entry points;
  2. hold the simulator's kernels against their plain PyTorch versions on
     the card, at the main path's shapes and at an edge shape, and time
     both (CUDA events around 10 back-to-back launches, median of 3 such
     runs after warm-up):
     seg_waterfill rates bit for bit and load within rtol 2e-6;
     fw_minplus bit for bit on dyadic weights, rtol 1e-5 otherwise;
  3. the same for the LM kernels, printing for each shape the variant
     that ran and its CUDA launches per call: flash_attention at the
     zamba2-1.2b prefill shape, a qwen2.5-3b GQA shape (Hq 16, Hkv 2,
     D 128), an edge shape (S below one tile, MQA, f32), a ragged S on the
     tensor-core variant (S 1000) and bf16 at D 32 on the FP32-pipe
     variant — on bf16 outputs every element within 2 bf16 ulps of the
     plain version's plus 1e-5, a limit that the same attention with p or
     the PV accumulator rounded to bf16 must miss at the zamba2 shape (the
     controls); rtol/atol 1e-5 on f32 — timed at the zamba2 and qwen2.5
     shapes with SDPA beside it as the library yardstick; ssd_scan at the
     zamba2-1.2b shape, the mamba2-1.3b shape (N 128) and a one-chunk
     ragged edge — within rtol/atol 1e-4;
  4. the paper experiment: the six policies at 20 hosts / 300 containers,
     horizon 120, kernels 'auto', each completing 300/300 and agreeing
     with the port's CPU run (plain versions) leaf by leaf;
  5. the simulator's main path at real size: 2000 hosts / 6000
     containers, 'fw' delay refresh, policy netaware, horizon 40 — launch
     counts reset just before and read just after, ticks/s and peak device
     memory printed; then the same run again, whose final state must be
     bit-identical;
  6. reduced zamba2 served on the card (kernels) against the port's CPU
     run (plain versions) from the same weights and prompts: prefill and
     decode logits within 4 bf16 ulps of their largest magnitude while
     the tokens agree, tokens equal wherever the CPU's top-2 margin
     exceeds twice that;
  7. the LM main path: zamba2-1.2b exactly as published, batch 4, prompt
     2048, 32 generated tokens, weights from init_params(seed=0) on the
     card — launch counts reset just before and read just after (6
     flash_attention and 38 ssd_scan launches in the prefill, none in
     decode), prefill ms, decode tok/s and peak device memory printed;
     the same prefill with the plain versions in place of the kernels
     must agree (logits within FULL_ULPS bf16 ulps of their largest
     magnitude: an end-to-end check of the port, not of the kernels'
     precision, which phase 3 holds; the gap of a prefill whose attention
     rounds p to bf16 is printed beside it); a second kernel run must be
     bit-identical.
The last lines are the card's name and power limit, one JSON line of
kernel measurements, and the result line.  Imports torch and repro_torch
only.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

# cuBLAS is deterministic only with a fixed workspace, set before CUDA
# starts (torch.use_deterministic_algorithms raises without it)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import (SimConfig, build_paper_hosts,  # noqa: E402
                              build_paper_network, get_policy, init_sim,
                              list_policies, paper_workload, run_sim,
                              scaled_hosts, summarize)
from repro_torch.core.convert import assert_state_close  # noqa: E402
from repro_torch.kernels import (LAUNCHES, _build,  # noqa: E402
                                 reset_launch_counts)
from repro_torch.kernels.fw_minplus import (floyd_warshall,  # noqa: E402
                                            floyd_warshall_ref)
from repro_torch.kernels.seg_waterfill import (seg_waterfill,  # noqa: E402
                                               seg_waterfill_ref)
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BF16_ATOL, BF16_ULPS, bf16_limit_share, flash_attention,
    flash_attention_ref)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref  # noqa: E402
from repro_torch.launch.serve import prompt_batch, serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

DEV = torch.device("cuda")
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, the FP32 rate
# outside the tensor cores (the simulator's kernels compute in f32), the
# dense TF32 tensor-core rate (ssd_scan's f32 inputs, whose products run
# on the tensor cores) and the dense bf16 tensor-core rate (the type of
# flash_attention's inputs on the model path)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12
PEAK_BF16_PER_S = 989e12
REPS = 10
MODEL_ULPS = 4   # reduced serve, card against CPU (see phase 6)
FULL_ULPS = 8    # full-width prefill, kernels against plain versions


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=REPS, warm=3, runs=3) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``; the median of ``runs`` such
    runs.  Back to back, the host enqueues ahead of the device, so this is
    the device's time per call, as on the model path, where the device is
    busy while the host launches."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, peak_ops=PEAK_FP32_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_report(name):
    """One line per tensor-core entry point of kernel ``name``'s build in
    this process (not the FP32-pipe flash_fwd_fp32), from ptxas's
    ``-Xptxas -v`` report: registers, static shared memory (the kernels
    take theirs dynamically, at launch), stack and spills."""
    out, label = {}, None
    for line in _build.BUILD_LOGS.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '\S*?((?:flash_fwd|ssd)_"
                      r"[a-z0-9]+?)(?:I(.*?)EE)?E", line)
        if m:
            args = (m.group(2) or "").replace("13__nv_bfloat16", "bf16,")
            args = re.sub(r"^f", "float,", args).replace("Li", "")
            label = m.group(1) + (f"<{args.strip(',')}>" if args else "")
            if not label.startswith("flash_fwd_fp32"):
                out[label] = []
            continue
        if label not in out:
            continue
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            smem = re.search(r"(\d+) bytes smem", line)
            out[label].insert(0, f"{regs.group(1)} registers, "
                                 f"{smem.group(1) if smem else 0} bytes "
                                 f"static smem")
        elif "spill" in line:
            out[label].append(line.strip())
    return [f"{k}: {', '.join(v)}" for k, v in out.items()]


# ---------------------------------------------------------------------------
# Phase 2 inputs
# ---------------------------------------------------------------------------
def main_path_flows(net, n_hosts, F, seed):
    """F flows between random hosts of the real-size fabric, routed on its
    ECMP paths as network.flow_rates routes them (inactive flows -1)."""
    r = np.random.default_rng(seed)
    src = torch.tensor(r.integers(0, n_hosts, F), device=DEV)
    dst = torch.tensor(r.integers(0, n_hosts, F), device=DEV)
    active = torch.tensor(r.uniform(size=F) < 0.8, device=DEV)
    links = torch.where(active[:, None], net.path_links[src, dst], -1)
    tcp = torch.where(torch.tensor(r.uniform(size=F) < 0.3, device=DEV),
                      torch.tensor(r.uniform(10, 1e4, F), dtype=torch.float32,
                                   device=DEV), 1e9).float()
    return links.int().contiguous(), active, net.link_bw_kbps, tcp


def random_flows(F, E, seed):
    r = np.random.default_rng(seed)
    links = r.integers(0, E, (F, 4)).astype(np.int32)
    links[np.arange(4)[None, :] >= r.integers(0, 5, F)[:, None]] = -1
    active = r.uniform(size=F) < 0.8
    bw = r.uniform(1e3, 1e5, E).astype(np.float32)
    tcp = np.where(r.uniform(size=F) < 0.3, r.uniform(10, 1e4, F),
                   1e9).astype(np.float32)
    return tuple(torch.tensor(x, device=DEV) for x in (links, active, bw, tcp))


def adjacency(n, seed, dyadic):
    r = np.random.default_rng(seed)
    if dyadic:   # multiples of 1/64: every path sum is exact in f32
        A = (r.integers(8, 512, (n, n)) / 64.0).astype(np.float32)
    else:
        A = r.uniform(0.1, 10, (n, n)).astype(np.float32)
    A[r.uniform(size=(n, n)) < 0.5] = 1e9
    A = np.minimum(A, A.T)
    np.fill_diagonal(A, 0.0)
    return torch.tensor(A, device=DEV)


def waterfill_ops(links, active, E, n_rounds=8):
    """Operations this input needs: per round and in the tail, a count add,
    a bound min and a used-capacity add per valid slot, a share divide and
    a capacity update per link, a global-min step per flow; then a load
    add per valid slot and a Mathis min per flow."""
    F = links.shape[0]
    slots = int(((links >= 0) & active.bool()[:, None]).sum())
    return (n_rounds + 1) * (3 * slots + 2 * E + F) + slots + F


def check_kernels(real_net, n_hosts):
    rows = {}
    # seg_waterfill: rates bit for bit, load within rtol 2e-6
    F, E = 12000, real_net.link_bw_kbps.shape[0]
    main = main_path_flows(real_net, n_hosts, F, seed=1)
    errs = []
    for name, args in ((f"F={F},E={E}", main),
                       ("F=8,E=5", random_flows(8, 5, seed=2))):
        rk, lk = seg_waterfill(*args)
        rr, lr = seg_waterfill_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(rk, rr):
            raise AssertionError(f"seg_waterfill {name}: rates differ, max "
                                 f"{(rk - rr).abs().max().item()}")
        torch.testing.assert_close(lk, lr, rtol=2e-6, atol=1e-3)
        errs.append(max((rk - rr).abs().max().item(),
                        (lk - lr).abs().max().item()))
        log(f"seg_waterfill {name}: rates bit-exact, load within rtol 2e-6")
    ms = time_ms(lambda: seg_waterfill(*main))
    plain = time_ms(lambda: seg_waterfill_ref(*main))
    links, active, bw, tcp = main
    n_bytes = 4 * (links.numel() + F + E + F) + 4 * (F + E)
    b, by = bound_ms(n_bytes, waterfill_ops(links, active, E))
    log(f"seg_waterfill F={F} E={E}: kernel {ms:.4f} ms, plain {plain:.4f} ms,"
        f" bound {b:.6f} ms ({by})")
    rows["seg_waterfill"] = dict(
        name="seg_waterfill", route="cuda",
        source="src/repro_torch/kernels/csrc/seg_waterfill.cu",
        replaces="src/repro/kernels/seg_waterfill/seg_waterfill.py:190",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b,
        bound_by=by, library_ms=None)

    # fw_minplus: bit-exact on dyadic weights, rtol 1e-5 otherwise
    n = 2402
    errs = []
    for name, A, exact in (("n=2402 dyadic", adjacency(n, 3, True), True),
                           ("n=2402 random", adjacency(n, 4, False), False),
                           ("n=37 dyadic", adjacency(37, 5, True), True)):
        Dk, Dr = floyd_warshall(A), floyd_warshall_ref(A)
        torch.cuda.synchronize()
        if exact and not torch.equal(Dk, Dr):
            raise AssertionError(f"fw_minplus {name}: not bit-exact, max "
                                 f"{(Dk - Dr).abs().max().item()}")
        torch.testing.assert_close(Dk, Dr, rtol=1e-5, atol=1e-4)
        errs.append((Dk - Dr).abs().max().item())
        log(f"fw_minplus {name}: {'bit-exact' if exact else 'within rtol 1e-5'}")
    A = adjacency(n, 4, False)
    ms = time_ms(lambda: floyd_warshall(A))
    plain = time_ms(lambda: floyd_warshall_ref(A))
    b, by = bound_ms(2 * 4 * n * n, 2.0 * n ** 3)
    log(f"fw_minplus n={n}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {b:.6f} ms ({by})")
    rows["fw_minplus"] = dict(
        name="fw_minplus", route="cuda",
        source="src/repro_torch/kernels/csrc/fw_minplus.cu",
        replaces="src/repro/kernels/fw_minplus/fw_minplus.py:100",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b,
        bound_by=by, library_ms=None)
    return rows


# ---------------------------------------------------------------------------
# Phase 3: the LM kernels
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def reference_mode():
    """Deterministic mode off for the plain versions and the library
    yardstick: ssd's plain version takes a CUDA cumsum, which has no
    deterministic implementation.  They are references; their run-to-run
    bits are not claimed."""
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(True)


def flash_inputs(B, S, Hq, Hkv, D, dtype, seed):
    r = np.random.default_rng(seed)
    return tuple(torch.tensor(r.standard_normal(shape), dtype=torch.float32,
                              device=DEV).to(dtype)
                 for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))


def ssd_inputs(B, S, H, P, N, seed):
    r = np.random.default_rng(seed)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=DEV)
    return (f(r.standard_normal((B, S, H, P)) * 0.5),
            f(r.standard_normal((B, S, N)) * 0.5),
            f(r.standard_normal((B, S, N)) * 0.5),
            f(r.uniform(0.01, 0.2, (B, S, H))), f(r.uniform(-1, 0.5, H)))


def flash_work(B, S, Hq, Hkv, D, elem):
    """(bytes, operations) of causal attention: q, k, v read once and o
    written once; 2 D multiply-adds per (q, k) pair with k <= q, for the
    scores and for the PV product."""
    n_bytes = elem * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    return n_bytes, 4.0 * B * Hq * D * (S * (S + 1) / 2)


def ssd_work(B, S, H, P, N, Q):
    """(bytes, operations) of the chunk scan: xs, B, C, dt and A_log read
    once, y and the final state written once; per (b, chunk of Qc) the
    causal half of C.B^T, N multiply-adds per pair (B and C have one
    group, so every head shares it); per (b, h, chunk) the causal half of
    M.xs, P multiply-adds per pair, plus Qc N P for C.h and Qc N P for the
    state update."""
    n_bytes = 4 * (2 * B * S * H * P + 2 * B * S * N + B * S * H + H
                   + B * H * P * N)
    ops = 0.0
    for c0 in range(0, S, Q):
        qc = min(Q, S - c0)
        pairs = qc * (qc + 1) / 2
        ops += 2.0 * B * (pairs * N + H * (pairs * P + 2 * qc * N * P))
    return n_bytes, ops


def attention_low_precision(q, k, v, causal=True, scale=None, round_p=True,
                            round_acc=False, tile=64):
    """Attention that rounds the probabilities p (``round_p``) or the PV
    accumulator after each ``tile`` of keys (``round_acc``) to bf16: the
    lower-precision controls the bf16 limit must reject.  Same arguments
    as flash_attention."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.float().reshape(B, S, Hkv, Hq // Hkv, D),
                     k.float()) * scale
    if causal:
        s = s.masked_fill(~torch.ones((S, S), dtype=torch.bool,
                                      device=q.device).tril(), -1e30)
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


def check_lm_kernels():
    rows = {}
    errs = []
    main = {}
    for name, shape, dtype in (
            ("zamba2-1.2b B=4 S=2048 Hq=Hkv=32 D=64 bf16",
             (4, 2048, 32, 32, 64), torch.bfloat16),
            ("qwen2.5-3b B=4 S=2048 Hq=16 Hkv=2 D=128 bf16",
             (4, 2048, 16, 2, 128), torch.bfloat16),
            ("edge B=2 S=40 Hq=8 Hkv=1 D=64 f32", (2, 40, 8, 1, 64),
             torch.float32),
            ("ragged B=1 S=1000 Hq=Hkv=4 D=64 bf16", (1, 1000, 4, 4, 64),
             torch.bfloat16),
            ("D=32 B=2 S=256 Hq=4 Hkv=2 bf16", (2, 256, 4, 2, 32),
             torch.bfloat16)):
        q, k, v = flash_inputs(*shape, dtype, seed=len(errs) + 10)
        ok = flash_attention(q, k, v)
        with reference_mode():
            op = flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        errs.append((ok.float() - op.float()).abs().max().item())
        how = (f"variant {fa_mod.variant(dtype, shape[4])}, "
               f"{fa_mod.CUDA_LAUNCHES_PER_CALL} CUDA launch per call")
        if dtype == torch.bfloat16:
            share = bf16_limit_share(ok, op)
            if share > 1:
                raise AssertionError(f"flash_attention {name}: {share:.3g} "
                                     f"of the bf16 limit")
            log(f"flash_attention {name} ({how}): within {BF16_ULPS} bf16 "
                f"ulps + {BF16_ATOL} of the plain version (max |err| "
                f"{errs[-1]:.3g}, {share:.3f} of the limit)")
        else:
            torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-5)
            log(f"flash_attention {name} ({how}): within rtol/atol 1e-5 of "
                f"the plain version (max |err| {errs[-1]:.3g})")
        if not main:
            with reference_mode():
                for what, kw in (("p", dict(round_p=True)),
                                 ("PV accumulator", dict(round_p=False,
                                                         round_acc=True))):
                    share = bf16_limit_share(
                        attention_low_precision(q, k, v, **kw), op)
                    if share <= 1:
                        raise AssertionError(f"the bf16 limit passed "
                                             f"attention with bf16 {what}")
                    log(f"flash_attention {name} control, {what} rounded "
                        f"to bf16: {share:.3f} of the limit (must exceed 1)")
        if len(main) < 2:             # timed: the zamba2 and qwen2.5 shapes
            main[name] = (shape, (q, k, v))
    for i, (name, (shape, (q, k, v))) in enumerate(main.items()):
        ms = time_ms(lambda: flash_attention(q, k, v))
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        with reference_mode():
            plain = time_ms(lambda: flash_attention_ref(q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                       enable_gqa=True))
        b, by = bound_ms(*flash_work(*shape, elem=2), peak_ops=PEAK_BF16_PER_S)
        log(f"flash_attention {name}: kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, SDPA {lib:.4f} ms, bound {b:.6f} ms ({by})")
        if i == 0:
            rows["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/"
                         "flash_attention.py:101",
                max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib)

    errs = []
    main = None
    for name, shape in (("zamba2-1.2b B=4 S=2048 H=64 P=64 N=64 Q=256",
                         (4, 2048, 64, 64, 64, 256)),
                        ("mamba2-1.3b B=4 S=2048 H=64 P=64 N=128 Q=256",
                         (4, 2048, 64, 64, 128, 256)),
                        ("edge one ragged chunk B=1 S=100 H=4 P=32 N=16",
                         (1, 100, 4, 32, 16, 256))):
        ins = ssd_inputs(*shape[:5], seed=len(errs) + 20)
        yk, hk = ssd_scan(*ins, shape[5])
        with reference_mode():
            yp, hp = ssd_scan_ref(*ins, shape[5])
        torch.cuda.synchronize()
        torch.testing.assert_close(yk, yp, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(hk, hp, rtol=1e-4, atol=1e-4)
        errs.append(max((yk - yp).abs().max().item(),
                        (hk - hp).abs().max().item()))
        share = max(((a - r).abs() / (1e-4 + 1e-4 * r.abs())).max().item()
                    for a, r in ((yk, yp), (hk, hp)))
        log(f"ssd_scan {name} (3xbf16 chunk passes, "
            f"{ssd_mod.CUDA_LAUNCHES_PER_CALL} CUDA launches per call): "
            f"within rtol/atol 1e-4 of the plain version (max |err| "
            f"{errs[-1]:.3g}, {share:.3f} of the limit)")
        if main is None:
            main = (shape, ins)
    shape, ins = main
    ms = time_ms(lambda: ssd_scan(*ins, shape[5]))
    with reference_mode():
        plain = time_ms(lambda: ssd_scan_ref(*ins, shape[5]))
    b, by = bound_ms(*ssd_work(*shape), peak_ops=PEAK_TF32_PER_S)
    log(f"ssd_scan {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {b:.6f} ms ({by})")
    rows["ssd_scan"] = dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/ssd_scan.py:96",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b,
        bound_by=by, library_ms=None)
    return rows


# ---------------------------------------------------------------------------
# Phases 6 and 7: serving
# ---------------------------------------------------------------------------
def ulp_bf16(m: float) -> float:
    """One bf16 ulp at magnitude ``m`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(m, 1e-30))) - 7)


def ulp_gap(got, ref):
    """Largest |got - ref| in bf16 ulps of ref's largest magnitude."""
    got, ref = got.float().cpu(), ref.float().cpu()
    return (got - ref).abs().max().item() / ulp_bf16(ref.abs().max().item())


def kernel_cfg(cfg):
    return dataclasses.replace(cfg, attn_impl="kernel", ssm_impl="kernel")


def compare_greedy(ref, got, ulps):
    """Hold ``got``'s greedy run to ``ref``'s (both from ``serve``): row by
    row, while the two runs have fed the same tokens, the logits must be
    within ``ulps`` bf16 ulps of their largest magnitude, and the next
    token must agree wherever ``ref``'s top-2 margin exceeds twice that.
    Returns (the largest gap in ulps, the tokens compared)."""
    worst, compared = 0.0, 0
    for b in range(ref["tokens"].shape[0]):
        steps = [(ref["logits"][b], got["logits"][b], None)] + [
            (ref["step_logits"][b, t], got["step_logits"][b, t], t)
            for t in range(ref["tokens"].shape[1])]
        for r, g, t in steps:
            gap = ulp_gap(g, r)
            worst = max(worst, gap)
            if gap > ulps:
                raise AssertionError(f"row {b} step {t}: logits {gap:.2f} "
                                     f"bf16 ulps apart (> {ulps})")
            same = r.argmax().item() == g.argmax().item()
            top = r.float().topk(2).values
            if (top[0] - top[1]).item() > 2 * ulps * ulp_bf16(
                    r.abs().max().item()):
                if not same:
                    raise AssertionError(f"row {b} step {t}: greedy token "
                                         f"differs with a clear margin")
                compared += 1
            if not same:
                break          # the runs now feed different tokens
    return worst, compared


def reduced_serve():
    """Reduced zamba2 on the card against the port's CPU run: same weights
    (drawn on the CPU, moved to the card) and prompts.  Two bf16 GEMM
    libraries sum in different orders, so a bf16 rounding can land one
    ulp apart and travel the residual stream: logits within MODEL_ULPS
    ulps while the tokens agree; tokens equal while the CPU's margin is
    clear."""
    cfg = kernel_cfg(get_reduced("zamba2-1.2b"))
    B, S, n = 4, 64, 8
    params = transformer.init_params(cfg, seed=0, device="cpu")
    cpu = serve(cfg, params, prompt_batch(cfg, B, S, 0, "cpu"), n)
    gpu = serve(cfg, transformer.map_leaves(lambda a: a.to(DEV), params),
                prompt_batch(cfg, B, S, 0, DEV), n)
    n_apps = cfg.n_layers // cfg.attn_every
    want = {"flash_attention": n_apps, "ssd_scan": cfg.n_layers}
    got = {k: gpu["prefill_launches"][k] for k in want}
    if got != want or any(gpu["decode_launches"].values()):
        raise AssertionError(f"reduced serve launches: prefill "
                             f"{gpu['prefill_launches']}, decode "
                             f"{gpu['decode_launches']}")
    gap, compared = compare_greedy(cpu, gpu, MODEL_ULPS)
    log(f"reduced zamba2 serve B={B} S={S} gen={n}: card equals the CPU run "
        f"({compared} of {B * n} tokens compared, logits at most {gap:.2f} "
        f"bf16 ulps apart), launches {gpu['prefill_launches']}")


@contextlib.contextmanager
def plain_versions(flash=flash_attention_ref):
    """The model's kernel wrappers swapped for their plain versions (the
    names the model looks up at each call), with ``flash`` in place of
    flash_attention: phase 7's reference run and its control."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    ssd = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
    saved = fa.flash_attention, ssd.ssd_scan
    fa.flash_attention, ssd.ssd_scan = flash, ssd_scan_ref
    try:
        yield
    finally:
        fa.flash_attention, ssd.ssd_scan = saved


def full_width_serve():
    cfg = kernel_cfg(get_config("zamba2-1.2b"))
    B, S, n = 4, 2048, 32
    t0 = time.time()
    params = transformer.init_params(cfg, seed=0, device=DEV)
    batch = prompt_batch(cfg, B, S, 0, DEV)
    torch.cuda.synchronize()
    leaves = []
    transformer.map_leaves(leaves.append, params)
    weights = sum(a.numel() * a.element_size() for a in leaves)
    log(f"zamba2-1.2b weights: {weights / 2**30:.3f} GiB, drawn in "
        f"{time.time() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    out = serve(cfg, params, batch, n)          # counts reset inside
    peak = torch.cuda.max_memory_allocated()
    pf, dec = out["prefill_launches"], out["decode_launches"]
    if (pf["flash_attention"], pf["ssd_scan"]) != (6, 38) or \
            dec["flash_attention"] or dec["ssd_scan"]:
        raise AssertionError(f"full-width launches: prefill {pf}, "
                             f"decode {dec}")
    toks = out["tokens"]
    if toks.shape != (B, n) or not bool(((toks >= 0)
                                         & (toks < cfg.vocab_padded)).all()):
        raise AssertionError(f"full-width tokens {toks.shape}")
    for k in ("logits", "step_logits"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"full-width {k} not finite")
    log(f"zamba2-1.2b serve B={B} prompt={S} gen={n}: prefill "
        f"{out['prefill_ms']:.3f} ms, decode {out['decode_tok_s']:.2f} tok/s,"
        f" peak device memory {peak / 2**30:.3f} GiB, launches prefill {pf}"
        f" decode {dec}")

    # the same prefill through the plain versions on the card
    with plain_versions(), reference_mode():
        reset_launch_counts()
        ref_logits, _, _ = transformer.prefill(cfg, params, batch)
        torch.cuda.synchronize()
        plain_counts = dict(LAUNCHES)
    if plain_counts["flash_attention"] or plain_counts["ssd_scan"]:
        raise AssertionError(f"plain-version prefill launched {plain_counts}")
    gap = ulp_gap(out["logits"], ref_logits)
    if gap > FULL_ULPS:
        raise AssertionError(f"full-width prefill logits {gap:.2f} bf16 ulps "
                             f"from the plain versions' (> {FULL_ULPS})")
    log(f"zamba2-1.2b prefill through the plain versions: logits "
        f"{gap:.2f} bf16 ulps from the kernels' (bound {FULL_ULPS})")
    with plain_versions(attention_low_precision), reference_mode():
        low_logits, _, _ = transformer.prefill(cfg, params, batch)
        torch.cuda.synchronize()
    log(f"zamba2-1.2b prefill control, attention with p rounded to bf16: "
        f"logits {ulp_gap(low_logits, ref_logits):.2f} bf16 ulps from the "
        f"plain versions' (a reading, not a check)")
    del low_logits

    out2 = serve(cfg, params, batch, n)
    for k in ("tokens", "logits", "step_logits"):
        if not torch.equal(out[k], out2[k]):
            raise AssertionError(f"second full-width run's {k} differs")
    log(f"zamba2-1.2b second run: bit-identical tokens and logits (prefill "
        f"{out2['prefill_ms']:.3f} ms, decode {out2['decode_tok_s']:.2f} "
        f"tok/s)")
    return {k: pf[k] + dec[k] for k in pf}


# ---------------------------------------------------------------------------
# Phases 4 and 5
# ---------------------------------------------------------------------------
def paper_state(cfg, device):
    spec, net = build_paper_network(cfg, device=device)
    sim0 = init_sim(build_paper_hosts(device=device),
                    paper_workload(cfg, seed=0, device=device), net)
    return spec, sim0


def paper_experiment():
    for policy, mode in [(p, "path") for p in list_policies()] + \
            [("netaware", "fw")]:
        cfg = SimConfig(delay_mode=mode)
        reset_launch_counts()
        spec, sim0 = paper_state(cfg, DEV)
        final, metrics = run_sim(sim0, cfg, get_policy(policy, device=DEV),
                                 spec.n_hosts, spec.n_nodes, cfg.horizon)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        rep = summarize(final, metrics)
        want_fw = cfg.horizon // cfg.delay_update_interval if mode == "fw" \
            else 0
        if counts != {"seg_waterfill": cfg.horizon, "fw_minplus": want_fw,
                      "flash_attention": 0, "ssd_scan": 0}:
            raise AssertionError(f"{policy}/{mode}: launch counts {counts}")
        if rep["n_completed"] != 300:
            raise AssertionError(f"{policy}/{mode}: completed "
                                 f"{rep['n_completed']}/300")
        # the reference: the port's CPU run through the plain versions
        spec_c, sim_c = paper_state(cfg, "cpu")
        ref, ref_m = run_sim(sim_c, cfg, get_policy(policy, device="cpu"),
                             spec_c.n_hosts, spec_c.n_nodes, cfg.horizon)
        assert_state_close(final, ref, rtol=1e-5, atol=1e-4)
        assert_state_close(metrics, ref_m, rtol=1e-4, atol=1e-4)
        log(f"paper {policy:18s} {mode}: completed 300/300, cost "
            f"{rep['total_cost']:.1f}, launches {counts}, matches the CPU run")


def real_size_run():
    H, C, horizon = 2000, 6000, 40
    cfg = SimConfig(n_jobs=C // 3, n_tasks=C, n_containers=C,
                    horizon=horizon, delay_mode="fw")
    hosts = scaled_hosts(H, H // 5, device=DEV)
    spec, net = build_paper_network(cfg, n_hosts=H, n_leaf=H // 5,
                                    device=DEV)
    sim0 = init_sim(hosts, paper_workload(cfg, seed=0, device=DEV), net)
    policy = get_policy("netaware", device=DEV)

    def once():
        t0 = time.time()
        final, metrics = run_sim(sim0, cfg, policy, spec.n_hosts,
                                 spec.n_nodes, horizon)
        torch.cuda.synchronize()
        return final, metrics, time.time() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    final, metrics, wall = once()
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if counts["seg_waterfill"] != horizon or counts["fw_minplus"] < 1:
        raise AssertionError(f"real-size run launch counts {counts}")
    rep = summarize(final, metrics)
    # every slot of this workload is born, so every float leaf is finite
    bad = [k for k, v in {**_leaves(final), **_leaves(metrics)}.items()
           if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"real-size run: non-finite leaves {bad}")
    log(f"real size {H} hosts / {C} containers / {spec.n_nodes} nodes, "
        f"fw, netaware, horizon {horizon}: {horizon / wall:.3f} ticks/s "
        f"({wall:.3f} s), peak device memory {peak / 2**20:.1f} MiB, "
        f"launches {counts}, peak deployed {rep['peak_deployed']}, "
        f"completed {rep['n_completed']}, decisions "
        f"{rep['total_decisions']}")
    if rep["total_decisions"] == 0:
        raise AssertionError("real-size run placed nothing")
    final2, metrics2, wall2 = once()
    for a, b, what in ((final, final2, "final state"),
                       (metrics, metrics2, "metrics")):
        la, lb = _leaves(a), _leaves(b)
        bad = [k for k in la if not torch.equal(la[k], lb[k])]
        if bad:
            raise AssertionError(f"second run's {what} differs in {bad}")
    log(f"real size second run: bit-identical final state and metrics "
        f"({horizon / wall2:.3f} ticks/s)")
    return counts


def _leaves(t, prefix=""):
    out = {}
    for k, v in t._asdict().items():
        if isinstance(v, tuple):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def main():
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.time()
    _build.build()
    log(f"built kernels {list(_build.SOURCES)} in {time.time() - t0:.2f} s")
    for name in ("flash_attention", "ssd_scan"):
        for line in ptxas_report(name):
            log(f"ptxas {name}: {line}")

    torch.use_deterministic_algorithms(True)
    # f32 products in full f32 and bf16 GEMMs summed in f32, as the JAX
    # package computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = SimConfig()
    _, real_net = build_paper_network(cfg, n_hosts=2000, n_leaf=400,
                                      device=DEV)
    rows = check_kernels(real_net, 2000)
    rows.update(check_lm_kernels())
    paper_experiment()
    sim_counts = real_size_run()
    reduced_serve()
    lm_counts = full_width_serve()
    for name, row in rows.items():
        lm = name in ("flash_attention", "ssd_scan")
        row["launches"] = (lm_counts if lm else sim_counts)[name]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(json.dumps({"kernels": [rows[k] for k in _build.SOURCES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
