"""End-to-end training launcher on one device (the JAX package's
``launch/train.py`` without the mesh).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --arch zamba2-1.2b --steps 4 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
        --batch 4 --seq 2048 --steps 4

The flags are those of ``python -m repro.launch.train`` but the mesh's
(``--model-parallel``, ``--sp``, ``--moe``), plus ``--device`` (default
``cuda``; without a CUDA device the run fails unless ``--device cpu`` is
given) and ``--impl`` (``kernel``, the default: flash_attention and
ssd_scan through their autograd Functions, whose wrappers run the plain
versions on the CPU; ``ref``: the model's reference path).  It integrates
the deterministic data pipeline, the AdamW train step, the checkpoint
cadence with restore-on-start, and the fault supervisor (heartbeat and
straggler bookkeeping).  On a CUDA device the run is deterministic
(``torch.use_deterministic_algorithms``) and bf16 GEMMs sum in f32.

A checkpoint ``step_<n>`` holds the state after n steps, and a restored
run starts at step n (the JAX launcher saves the state after step n as
``step_<n>`` and restarts at n, which replays batch n once more).  Prints
the JAX launcher's per-step line, then the kernel launch counts.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.types import resolve_device
from repro_torch.data.pipeline import DataConfig, make_dataset, to_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.fault import (FaultConfig, HeartbeatMonitor,
                                           StragglerDetector,
                                           TrainingSupervisor)
from repro_torch.kernels import LAUNCHES, reset_launch_counts
from repro_torch.models.config import IMPLS
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import (StepConfig, init_train_state,
                                    make_train_step)

WORKER = "pod0:0"


def set_deterministic(device: torch.device) -> None:
    """On a CUDA device: deterministic algorithms (cuBLAS needs a fixed
    workspace for them, set here before its first GEMM) and bf16 GEMMs
    summed in f32, as the JAX package computes them."""
    if device.type != "cuda":
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--impl", choices=IMPLS, default="kernel")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    set_deterministic(device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl=args.impl, ssm_impl=args.impl)

    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps)
    step_cfg = StepConfig(n_microbatches=args.microbatches)
    train_step = make_train_step(cfg, opt_cfg, step_cfg)
    state = init_train_state(cfg, args.seed, device)
    data = make_dataset(DataConfig(
        seq_len=args.seq, global_batch=args.batch, vocab=cfg.vocab,
        seed=args.seed, frontend=cfg.frontend, n_prefix=cfg.n_prefix,
        d_model=cfg.d_model))

    start_step = 0
    if args.ckpt_dir:
        latest = ckpt.latest_step_dir(args.ckpt_dir)
        if latest:
            state, start_step = ckpt.restore_checkpoint(latest, state)
            print(f"[restore] resumed from {latest} @ step {start_step}")

    def save_fn(n_done: int) -> None:
        d = os.path.join(args.ckpt_dir, f"step_{n_done}")
        ckpt.save_checkpoint(d, state, n_done)
        print(f"[ckpt] saved {d}")

    sup = TrainingSupervisor(FaultConfig(), args.ckpt_every,
                             save_fn=save_fn, restore_fn=lambda: start_step)
    monitor = HeartbeatMonitor([WORKER], FaultConfig())
    straggler = StragglerDetector(FaultConfig())

    reset_launch_counts()
    losses, step_ms = [], []
    loss = float("nan")
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = to_device(data.batch_at(step), device)
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])         # waits for the step
        dt = time.perf_counter() - t0
        losses.append(loss)
        step_ms.append(dt * 1e3)
        monitor.beat(WORKER)
        straggler.record(WORKER, dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:8.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{dt * 1e3:7.1f} ms")
        assert np.isfinite(loss), f"loss diverged at step {step}"
        if args.ckpt_dir:
            sup.maybe_checkpoint(step + 1)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    med = statistics.median(step_ms[1:] or step_ms) if step_ms else 0.0
    print(f"[train] {cfg.name} on {name}; impl {args.impl}; batch "
          f"{args.batch} x seq {args.seq}; median step {med:.1f} ms "
          f"({args.batch * args.seq / max(med, 1e-9) * 1e3:.1f} tokens/s); "
          f"kernel launches {dict(LAUNCHES)}; stragglers "
          f"{straggler.stragglers()}")
    print("[done] final loss", loss)
    return {"state": state, "losses": losses, "step_ms": step_ms,
            "launches": dict(LAUNCHES), "start_step": start_step}


if __name__ == "__main__":
    main()
