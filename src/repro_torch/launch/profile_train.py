"""Where a training step's time goes: profile one step on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \\
        --arch zamba2-1.2b --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.profile_train \\
        --arch olmoe-1b-7b --layers 4 --batch 4 --seq 2048

From ``init_train_state(seed)`` and ``SyntheticLM(seed)``'s first batch,
runs one train step to warm up (kernels, remat as the config has it),
then the step's two parts again, each under ``torch.profiler``: the loss
and its gradients (``train.step.value_and_grad``: the forward, the remat
rerun and the backward, the kernels' plain-version VJPs among it) and the
AdamW update.  For each it prints ``launch.profile_serve``'s report: the
wall time (the profiler slows the host, so it is above an unprofiled
step's), the launches, the device's busy share, the device time by class
(the hand-written kernels, GEMMs, everything else) and the kernels with
the most device time.  ``--layers`` cuts the depth at the published
widths (olmoe-1b-7b's 16 layers do not fit one card in training).  The
last line is the same as one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.types import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.launch.profile_serve import report, window
from repro_torch.launch.train import set_deterministic
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import step as step_mod


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    on_cuda = device.type == "cuda"
    set_deterministic(device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl="kernel", ssm_impl="kernel",
                              n_layers=args.layers or cfg.n_layers)
    opt_cfg = opt_mod.OptimizerConfig()
    state = step_mod.init_train_state(cfg, args.seed, device)
    batch = to_device(SyntheticLM(DataConfig(
        seq_len=args.seq, global_batch=args.batch, vocab=cfg.vocab,
        seed=args.seed, frontend=cfg.frontend, n_prefix=cfg.n_prefix,
        d_model=cfg.d_model)).batch_at(0), device)
    loss_fn = step_mod.make_loss_fn(cfg)
    state, _ = step_mod.make_train_step(cfg, opt_cfg)(state, batch)  # warm

    out = {}
    grads = window(lambda: out.update(g=step_mod.value_and_grad(
        loss_fn, state.params, batch)[2]), on_cuda, n_top=16)
    update = window(lambda: opt_mod.adamw_update(
        opt_cfg, state.params, out["g"], state.opt), on_cuda)
    name = torch.cuda.get_device_name(device) if on_cuda else "cpu"
    print(f"{cfg.name} ({cfg.n_layers} layers): batch {args.batch}, seq "
          f"{args.seq}, remat "
          f"{cfg.remat}, on {name}")
    report("loss and gradients", grads)
    report("AdamW update", update)
    result = {"arch": cfg.name, "layers": cfg.n_layers,
              "batch": args.batch, "seq": args.seq,
              "device": name, "grads": grads, "update": update}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
