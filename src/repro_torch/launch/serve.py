"""Batched serving driver on PyTorch: prefill a batch of prompts, decode N
tokens greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --arch zamba2-1.2b

The flags are those of ``python -m repro.launch.serve`` that the port
supports, plus ``--device`` (default ``cuda``; without a CUDA device the
run fails unless ``--device cpu`` is given) and ``--impl`` (``kernel``,
the default: the flash_attention and ssd_scan kernels, whose wrappers run
their plain versions on the CPU; ``ref``: the model's reference path),
applied to both ``attn_impl`` and ``ssm_impl``; deepseek's MLA has no
kernel and takes ``--impl ref``.  Weights are random, from
``--seed``.  Prints the JAX launcher's line plus the device, prefill
milliseconds, decode tokens/s and the kernel launch counts.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.types import resolve_device
from repro_torch.kernels import LAUNCHES, reset_launch_counts
from repro_torch.models import transformer
from repro_torch.models.config import IMPLS
from repro_torch.serve.step import decode_loop, start


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


def serve(cfg, params, batch, n_gen: int) -> dict:
    """Greedy generation as ``serve.step.generate`` runs it, timed: the
    prefill and the decode loop each end in a device sync.  Returns the
    tokens [B, n_gen], the prefill's last-position logits and each decode
    step's logits [B, n_gen, Vp], ``prefill_ms``, ``decode_tok_s`` and the
    kernel launches of the prefill and of the decode loop."""
    first = next(iter(batch.values()))
    device, B = first.device, first.shape[0]
    reset_launch_counts()
    _sync(device)
    t0 = time.perf_counter()
    tok, logits, cache, seq_len = start(cfg, params, batch, n_gen)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    prefill_launches = dict(LAUNCHES)
    reset_launch_counts()
    t0 = time.perf_counter()
    toks, step_logits = decode_loop(cfg, params, tok, cache, seq_len, n_gen)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return {"tokens": toks, "logits": logits, "step_logits": step_logits,
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--impl", choices=IMPLS, default="kernel")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # bf16 GEMMs accumulate in f32 throughout, as the JAX package's do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl=args.impl, ssm_impl=args.impl)
    params = transformer.init_params(cfg, seed=args.seed, device=device)
    batch = prompt_batch(cfg, args.batch, args.prompt_len, args.seed, device)

    out = serve(cfg, params, batch, args.gen)
    B, S, toks = args.batch, args.prompt_len, out["tokens"].cpu().numpy()
    dt = out["seconds"]
    print(f"[serve] {cfg.name}: batch={B} prompt={S} gen={args.gen} "
          f"in {dt:.2f}s ({B * args.gen / dt:.1f} tok/s)")
    print("first sequence:", toks[0][:16], "...")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[serve] device {name}; impl {args.impl}; prefill "
          f"{out['prefill_ms']:.3f} ms; decode {out['decode_tok_s']:.1f} "
          f"tok/s; kernel launches: prefill {out['prefill_launches']}, "
          f"decode {out['decode_launches']}")
    assert toks.shape == (B, args.gen)
    assert (toks >= 0).all() and (toks < cfg.vocab_padded).all()
    return out


if __name__ == "__main__":
    main()
