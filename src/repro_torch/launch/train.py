"""End-to-end training launcher (the JAX package's ``launch/train.py``),
on one device or as N processes over a device mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --arch zamba2-1.2b --steps 4 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
        --batch 4 --seq 2048 --steps 4
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --device cpu --reduced \\
        --arch olmoe-1b-7b --model-parallel 2

The flags are those of ``python -m repro.launch.train``, plus
``--device`` (default ``cuda``; without a CUDA device the run fails unless
``--device cpu`` is given), ``--impl`` (``kernel``, the default:
flash_attention and ssd_scan through their autograd Functions, whose
wrappers run the plain versions on the CPU; ``ref``: the model's reference
path).  Run as N processes under ``torchrun``
(``python -m torch.distributed.run``, which comes with torch and sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` and one CPU thread a rank), each rank
joins the process group (NCCL where the ranks on its host have a card
each, else gloo, whose collectives stage CUDA tensors through host
memory; rank 0 says so), builds
``make_mesh_for(world size, --model-parallel)`` and trains its shards of
the state on its shard of each global batch (``train/step.py``); rank i
takes ``cuda:(LOCAL_RANK % cards)``.  ``--sp`` and ``--moe`` set the
config's ``seq_parallel`` and ``moe_impl``.  Only rank 0 prints; a
checkpoint is gathered leaf by leaf and written by rank 0.  It integrates
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
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.types import resolve_device
from repro_torch.data.pipeline import DataConfig, make_dataset, to_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.fault import (FaultConfig, HeartbeatMonitor,
                                           StragglerDetector,
                                           TrainingSupervisor)
from repro_torch.kernels import LAUNCHES, reset_launch_counts
from repro_torch.launch.mesh import join_group, make_mesh_for
from repro_torch.models.config import IMPLS
from repro_torch.models.sharding import data_axes
from repro_torch.models.transformer import _sp_mode
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import (StepConfig, init_train_state,
                                    make_train_step, state_shardings)


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
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--impl", choices=IMPLS, default="kernel")
    ap.add_argument("--sp", default=None, choices=["off", "attn", "full"],
                    help="the config's seq_parallel: the port reads it for "
                    "the JAX layout it would choose, printed on a mesh, and "
                    "computes with the sequence whole (the same math)")
    ap.add_argument("--moe", default=None, choices=["psum", "a2a"],
                    help="the config's moe_impl")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    rank, world = 0, 1
    if "WORLD_SIZE" in os.environ:
        rank, world, device, _ = join_group(device)
    try:
        return _train(args, device, rank, world)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args, device, rank: int, world: int) -> dict:
    say = print if rank == 0 else (lambda *a, **k: None)
    set_deterministic(device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl=args.impl, ssm_impl=args.impl)
    if args.sp:
        cfg = dataclasses.replace(cfg, seq_parallel=args.sp)
    if args.moe:
        cfg = dataclasses.replace(cfg, moe_impl=args.moe)
    mesh, dp, shardings = None, ("data",), None
    if world > 1 or args.model_parallel > 1:
        mesh = make_mesh_for(world, args.model_parallel, device.type)
        dp = data_axes(mesh)
        shardings = state_shardings(cfg, mesh)
        say(f"[mesh] {tuple(mesh.shape)} {mesh.mesh_dim_names} over {world} "
            f"ranks ({dist.get_backend()}), batch over {dp}; seq_parallel "
            f"{cfg.seq_parallel!r} -> {_sp_mode(cfg, mesh, args.seq, False)!r}"
            f" in the JAX layout (the port computes it with the sequence "
            f"whole), moe_impl {cfg.moe_impl!r}")

    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=args.steps)
    step_cfg = StepConfig(n_microbatches=args.microbatches)
    train_step = make_train_step(cfg, opt_cfg, step_cfg, mesh=mesh, dp=dp)
    state = init_train_state(cfg, args.seed, device, mesh)
    data = make_dataset(DataConfig(
        seq_len=args.seq, global_batch=args.batch, vocab=cfg.vocab,
        seed=args.seed, frontend=cfg.frontend, n_prefix=cfg.n_prefix,
        d_model=cfg.d_model))

    start_step = 0
    if args.ckpt_dir:
        latest = ckpt.latest_step_dir(args.ckpt_dir)
        if latest:
            state, start_step = ckpt.restore_checkpoint(latest, state,
                                                        shardings)
            say(f"[restore] resumed from {latest} @ step {start_step}")

    def save_fn(n_done: int) -> None:
        d = os.path.join(args.ckpt_dir, f"step_{n_done}")
        ckpt.save_checkpoint(d, state, n_done, rank, shardings)
        if mesh is not None:
            dist.barrier()
        say(f"[ckpt] saved {d}")

    sup = TrainingSupervisor(FaultConfig(), args.ckpt_every,
                             save_fn=save_fn, restore_fn=lambda: start_step)
    worker = f"pod0:{rank}"          # this rank, in the JAX launcher's naming
    monitor = HeartbeatMonitor([worker], FaultConfig())
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
        monitor.beat(worker)
        straggler.record(worker, dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d}  loss {loss:8.4f}  "
                f"lr {float(metrics['lr']):.2e}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"{dt * 1e3:7.1f} ms")
        assert np.isfinite(loss), f"loss diverged at step {step}"
        if args.ckpt_dir:
            sup.maybe_checkpoint(step + 1)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    med = statistics.median(step_ms[1:] or step_ms) if step_ms else 0.0
    say(f"[train] {cfg.name} on {name} x {world}; impl {args.impl}; batch "
        f"{args.batch} x seq {args.seq}; median step {med:.1f} ms "
        f"({args.batch * args.seq / max(med, 1e-9) * 1e3:.1f} tokens/s); "
        f"kernel launches {dict(LAUNCHES)}; stragglers "
        f"{straggler.stragglers()}")
    say("[done] final loss", loss)
    return {"state": state, "losses": losses, "step_ms": step_ms,
            "launches": dict(LAUNCHES), "start_step": start_step}


if __name__ == "__main__":
    main()
