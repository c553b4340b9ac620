"""Batched serving driver on PyTorch: prefill a batch of prompts, decode N
tokens greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --arch zamba2-1.2b
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.serve --device cpu --reduced \\
        --arch olmoe-1b-7b --model-parallel 2

The flags are those of ``python -m repro.launch.serve``, plus
``--device`` (default ``cuda``; without a CUDA device the run fails
unless ``--device cpu`` is given) and ``--impl`` (``kernel``, the
default: the flash_attention and ssd_scan kernels, whose wrappers run
their plain versions on the CPU; ``ref``: the model's reference path),
applied to both ``attn_impl`` and ``ssm_impl``; deepseek's MLA has no
kernel and takes ``--impl ref``.  Weights are random, from ``--seed``.
Every run builds ``make_mesh_for(world size, --model-parallel)``: one
process with no group builds the one-rank mesh (the one-card path); as N
processes under ``torchrun`` each rank joins the process group as
``launch/train.py`` does (``launch.mesh.join_group``: NCCL where the
ranks on a host have a card each, else gloo, said so) and serves its
shards of the weights and its rows of the batch
(``serve/step.py``).  Rank 0 prints the JAX launcher's line plus the
mesh, the device, prefill milliseconds, decode tokens/s and its kernel
launch counts.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.types import resolve_device
from repro_torch.kernels import LAUNCHES, reset_launch_counts
from repro_torch.launch.mesh import join_group, make_mesh_for
from repro_torch.models.config import IMPLS
from repro_torch.models.sharding import data_axes
from repro_torch.serve.step import all_rows, decode_loop, init_params, start


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_batch(cfg, batch: int, prompt_len: int, seed: int, device):
    """A batch of ``batch`` random prompts of ``prompt_len`` positions from
    ``seed``, drawn with numpy as the JAX launcher draws them and in its
    order: token ids [B, S]; for paligemma's patch frontend first the
    ``n_prefix`` patch embeddings [B, Np, d] (standard normal, bf16), then
    the text tokens [B, S - Np]; for musicgen's frame frontend the frame
    embeddings [B, S, d] alone."""
    rng = np.random.default_rng(seed)
    B, S = batch, prompt_len
    # f64 draws reach bf16 through f32, as jnp.asarray(..., bfloat16) does
    embeds = lambda shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device).to(
            torch.bfloat16)
    tokens = lambda n: torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)).to(device)
    if cfg.frontend == "patch_embeds":
        patches = embeds((B, cfg.n_prefix, cfg.d_model))
        return {"patch_embeds": patches, "tokens": tokens(S - cfg.n_prefix)}
    if cfg.frontend == "frame_embeds":
        return {"frame_embeds": embeds((B, S, cfg.d_model))}
    return {"tokens": tokens(S)}


def serve(cfg, params, batch, n_gen: int, mesh=None,
          dp: tuple = ("data",)) -> dict:
    """Greedy generation as ``serve.step.generate`` runs it, timed: the
    prefill and the decode loop each end in a device sync.  Returns the
    tokens [B, n_gen], the prefill's last-position logits and each decode
    step's logits [B, n_gen, Vp], ``prefill_ms``, ``decode_tok_s`` and the
    kernel launches of the prefill and of the decode loop; on a mesh of
    several ranks, the global tokens and the logits of the rank's rows
    (with its ``cache``, the rank's ShardedCache)."""
    first = next(iter(batch.values()))
    device, B = first.device, first.shape[0]
    reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    tok, logits, cache, seq_len = start(cfg, params, batch, n_gen, None,
                                        mesh, dp)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    prefill_launches = dict(LAUNCHES)
    reset_launch_counts()
    t0 = time.perf_counter()
    toks, step_logits = decode_loop(cfg, params, tok, cache, seq_len, n_gen,
                                    mesh, dp)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return {"tokens": all_rows(toks, cache), "logits": logits,
            "step_logits": step_logits, "cache": cache,
            "prefill_ms": prefill_s * 1e3,
            "decode_tok_s": B * n_gen / decode_s if n_gen else 0.0,
            "seconds": prefill_s + decode_s,
            "prefill_launches": prefill_launches,
            "decode_launches": dict(LAUNCHES)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--impl", choices=IMPLS, default="kernel")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    rank, world = 0, 1
    started = not dist.is_initialized()
    if "WORLD_SIZE" in os.environ:
        rank, world, device, _ = join_group(device)
    try:
        return _serve(args, device, rank, world)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _serve(args, device, rank: int, world: int) -> dict:
    say = print if rank == 0 else (lambda *a, **k: None)
    # bf16 GEMMs accumulate in f32 throughout, as the JAX package's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl=args.impl, ssm_impl=args.impl)
    mesh = make_mesh_for(world, args.model_parallel, device.type)
    dp = data_axes(mesh)
    say(f"[mesh] {tuple(mesh.shape)} {mesh.mesh_dim_names} over {world} "
        f"ranks ({dist.get_backend()}), batch over {dp}")
    params = init_params(cfg, seed=args.seed, device=device, mesh=mesh)
    batch = prompt_batch(cfg, args.batch, args.prompt_len, args.seed, device)

    out = serve(cfg, params, batch, args.gen, mesh, dp)
    B, S, toks = args.batch, args.prompt_len, out["tokens"].cpu().numpy()
    dt = out["seconds"]
    say(f"[serve] {cfg.name}: batch={B} prompt={S} gen={args.gen} "
        f"in {dt:.2f}s ({B * args.gen / dt:.1f} tok/s)")
    say("first sequence:", toks[0][:16], "...")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    say(f"[serve] device {name} x {world}; impl {args.impl}; prefill "
        f"{out['prefill_ms']:.3f} ms; decode {out['decode_tok_s']:.1f} "
        f"tok/s; kernel launches: prefill {out['prefill_launches']}, "
        f"decode {out['decode_launches']}")
    if toks.shape != (B, args.gen) or not (
            (toks >= 0).all() and (toks < cfg.vocab_padded).all()):
        raise RuntimeError(f"generated tokens of shape {toks.shape} out of "
                           f"[0, {cfg.vocab_padded})")
    return out


if __name__ == "__main__":
    main()
