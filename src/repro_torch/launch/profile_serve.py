"""Where serving time goes: profile one prefill and a window of decode
steps on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch zamba2-1.2b --batch 4 --prompt-len 2048 --steps 8

Runs one prefill and ``--steps`` decode steps to warm up, then each again
under ``torch.profiler`` (CPU and CUDA activity), and prints for the
prefill and for the decode window: the wall time (host clock after a
synchronize; the profiler slows the host, so it is above an unprofiled
run's), the kernel launches, the device's busy share (summed device-side
event time over wall time, "not measured" when the profiler sees no
device activity), the device time by class (the hand-written kernels,
GEMMs, everything else) and the kernels with the most device time.  The
last line is the same as one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.types import resolve_device
from repro_torch.launch.profile import device_summary
from repro_torch.launch.serve import prompt_batch
from repro_torch.models import transformer
from repro_torch.serve.step import decode_loop, start

OURS = ("ssd_cum", "ssd_cb", "ssd_state", "ssd_pass", "ssd_out",
        "flash_fwd", "seg_waterfill", "fw_phase")
GEMM = ("gemm", "xmma", "cutlass", "nvjet", "gemv")


def kernel_class(name: str) -> str:
    if any(k in name for k in OURS):
        return "hand-written"
    low = name.lower()
    return "gemm" if any(k in low for k in GEMM) else "other"


def window(fn, on_cuda: bool, n_top: int = 10) -> dict:
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda
                                     else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if on_cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, kernels, device_ms = device_summary(prof.events())
    by_class: dict[str, float] = {}
    for name, (ms, _) in kernels.items():
        c = kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + ms
    top = sorted(((n, ms, c) for n, (ms, c) in kernels.items()),
                 key=lambda r: -r[1])[:n_top]
    return {"wall_ms": wall * 1e3, "launches": launches,
            "device_ms": device_ms if device_ms > 0 else None,
            "device_busy_share": (device_ms / (wall * 1e3)
                                  if device_ms > 0 else None),
            "device_ms_by_class": by_class,
            "top_kernels": [{"name": n, "ms": ms, "count": c}
                            for n, ms, c in top]}


def report(what: str, w: dict, per: int = 1) -> None:
    busy = w["device_busy_share"]
    print(f"{what}: {w['wall_ms']:.3f} ms wall, {w['launches'] / per:.1f} "
          f"launches{' per step' if per > 1 else ''}, device busy share "
          + (f"{busy:.4f} ({w['device_ms']:.3f} ms)" if busy is not None
             else "not measured"))
    print("  device ms by class: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(w["device_ms_by_class"].items())))
    for k in w["top_kernels"]:
        print(f"  {k['ms']:10.3f} ms  {k['count']:6d}x  {k['name'][:90]}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    on_cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl="kernel", ssm_impl="kernel")
    params = transformer.init_params(cfg, seed=args.seed, device=device)
    batch = prompt_batch(cfg, args.batch, args.prompt_len, args.seed, device)
    n = args.steps

    tok, _, cache, S = start(cfg, params, batch, n)        # warm-up
    decode_loop(cfg, params, tok, cache, S, n)
    state = {}
    pf = window(lambda: state.update(zip(
        ("tok", "logits", "cache", "S"), start(cfg, params, batch, n))),
        on_cuda)
    dec = window(lambda: decode_loop(cfg, params, state["tok"],
                                     state["cache"], state["S"], n), on_cuda)
    print(f"{cfg.name}: batch {args.batch}, prompt {args.prompt_len}, "
          f"{n} decode steps, on "
          f"{torch.cuda.get_device_name(device) if on_cuda else 'cpu'}")
    report("prefill", pf)
    report(f"decode ({n} steps)", dec, per=n)
    out = {"arch": cfg.name, "batch": args.batch,
           "prompt_len": args.prompt_len, "steps": n,
           "device": (torch.cuda.get_device_name(device) if on_cuda
                      else "cpu"),
           "prefill": pf, "decode": dec}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
