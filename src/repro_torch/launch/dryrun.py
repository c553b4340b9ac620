"""Multi-pod dry run of the port (the JAX package's ``launch/dryrun.py``):
every (architecture x input shape x mesh) cell of the production meshes
traced for one rank, with zero device allocation, and priced with H100
constants.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The JAX dry run lowers and compiles each cell against 256 or 512 XLA host
devices and reads the cost from what it compiled.  The port has no
compiler: a cell runs the port's own step for rank 0 of
``launch.mesh.make_production_mesh`` (a ShapeMesh) on ``meta`` tensors,
inside a ``launch.roofline.CostCounter``, which counts its FLOPs, HBM
bytes, peak live bytes and collectives (see that module for what differs
from XLA's ``cost_analysis``).  Per shape kind the cell runs:

* ``train``: ``train/step.py:make_train_step(..., mesh=, dp=)`` on the
  state drawn shard by shard and the global batch;
* ``prefill``: ``serve/step.py:make_prefill_step``;
* ``decode``: one step of ``make_decode_step`` against a cache
  ``seq_len`` deep (the rank's ``ShardedCache``), writing its last slot.

The serving cells take f32 parameters, as the JAX dry run lowers them
(``launch/serve.py`` stores the bf16 leaves in bf16).  The stack is a
Python loop, so the count is exact at full depth; ``probe_depths`` and
``probe_costs`` give JAX's two-probe extrapolation beside it.  ``--impl``
(default ``kernel``, as ``launch/serve.py``) sets ``attn_impl`` and
``ssm_impl``; MLA takes ``ref`` (``models/mla.py:check_impl``).

Rows carry JAX's keys (so that ``core/bridge.py:jobs_from_results`` of
either package reads them) and two more, ``kernels`` (the hand-written
kernels' calls) and ``flops_by_dtype``: ``lower_s`` is the trace's wall
time (inputs drawn on meta and the step run), ``compile_s`` 0.0
(nothing compiles), and ``memory_analysis`` holds
``argument_size_bytes`` (the rank's shard bytes of the step's inputs;
the port takes a decode step's cache length as a host int, where JAX's
``clen`` is a 4-byte device scalar), ``output_size_bytes`` (the step's
outputs on the rank), ``temp_size_bytes`` (the counter's peak live bytes
less the tensors the step was given: the port's steps take the global
batch) and ``generated_code_size_bytes`` 0.  Results accumulate in
``experiments/dryrun_results_torch.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import time
import traceback
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, cell_is_runnable,
                                 get_config)
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding as shd
from repro_torch.models import transformer
from repro_torch.models.config import IMPLS, ModelConfig, ShapeSpec
from repro_torch.serve.step import (init_params, make_decode_step,
                                    make_prefill_step)
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import (StepConfig, init_train_state,
                                    make_train_step)

RESULTS_PATH = os.path.join(os.path.dirname(__file__),
                            "../../../experiments/dryrun_results_torch.json")
META = torch.device("meta")


def cell_config(cfg: ModelConfig, impl: str = "kernel") -> ModelConfig:
    """``cfg`` with ``attn_impl`` and ``ssm_impl`` set to ``impl``; MLA's
    attention ``ref`` (it has no kernel)."""
    return dataclasses.replace(cfg, attn_impl="ref" if cfg.use_mla else impl,
                               ssm_impl=impl)


# ---------------------------------------------------------------------------
# Inputs: meta tensors, global, with the rank's shard bytes beside them
# ---------------------------------------------------------------------------
def input_batch(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """The global batch of the cell's step on ``meta`` (JAX's
    ``input_specs`` without the shardings)."""
    B, S = shape.global_batch, shape.seq_len
    t = lambda shp, dtype: torch.empty(shp, dtype=dtype, device=META)
    if shape.kind == "decode":
        return {"tokens": t((B, 1), torch.int32)}
    if cfg.frontend == "patch_embeds":
        s_text = S - cfg.n_prefix
        out = {"patch_embeds": t((B, cfg.n_prefix, cfg.d_model),
                                 torch.bfloat16),
               "tokens": t((B, s_text), torch.int32),
               "labels": t((B, s_text), torch.int32)}
    elif cfg.frontend == "frame_embeds":
        out = {"frame_embeds": t((B, S, cfg.d_model), torch.bfloat16),
               "labels": t((B, S), torch.int32)}
    else:
        out = {"tokens": t((B, S), torch.int32),
               "labels": t((B, S), torch.int32)}
    if shape.kind == "prefill":
        out.pop("labels", None)
    return out


def shard_bytes(batch: Dict[str, torch.Tensor], cfg, shape, mesh) -> int:
    """The rank's bytes of the global ``batch`` under ``batch_specs``."""
    specs = shd.batch_specs(cfg, shape, mesh)
    return sum(_nbytes(x[shd.shard_slices(specs[k], x.shape, mesh)])
               for k, x in batch.items())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(tree) -> list:
    """The tensors of a tree of dicts, tuples and lists, each once."""
    if isinstance(tree, dict):
        leaves = [x for k in sorted(tree) for x in _flat(tree[k])]
    elif isinstance(tree, (tuple, list)):
        leaves = [x for v in tree for x in _flat(v)]
    else:
        leaves = [tree] if torch.is_tensor(tree) else []
    return list({id(t): t for t in leaves}.values())


def _bytes(tree) -> int:
    return sum(_nbytes(t) for t in _flat(tree))


# ---------------------------------------------------------------------------
# One cell traced
# ---------------------------------------------------------------------------
def cell_program(cfg: ModelConfig, shape: ShapeSpec, mesh,
                 step_cfg: StepConfig = StepConfig()):
    """(step, args, the rank's argument bytes) of the cell on ``mesh``,
    every tensor on ``meta``."""
    dp = shd.data_axes(mesh)
    batch = input_batch(cfg, shape)
    in_bytes = shard_bytes(batch, cfg, shape, mesh)
    if shape.kind == "train":
        state = init_train_state(cfg, 0, META, mesh)
        step = make_train_step(cfg, OptimizerConfig(), step_cfg, mesh=mesh,
                               dp=dp)
        return step, (state, batch), _bytes(state) + in_bytes
    params = init_params(cfg, 0, META, mesh, masters=True)
    if shape.kind == "prefill":
        return (make_prefill_step(cfg, mesh, dp), (params, batch),
                _bytes(params) + in_bytes)
    cache = transformer.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   device=META, mesh=mesh)
    decode = make_decode_step(cfg, mesh, dp)
    last = shape.seq_len - 1
    step = lambda params, tokens, cache: decode(params, tokens, cache, last)
    return (step, (params, batch["tokens"], cache),
            _bytes(params) + in_bytes + _bytes(cache))


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               step_cfg: StepConfig = StepConfig()):
    """Run the cell's step inside a CostCounter: (the counter, the rank's
    argument bytes, its output bytes, the wall seconds of drawing the
    inputs on meta and tracing)."""
    t0 = time.perf_counter()
    step, args, arg_bytes = cell_program(cfg, shape, mesh, step_cfg)
    with torch.no_grad() if shape.kind != "train" \
            else contextlib.nullcontext(), \
            roofline.CostCounter(args) as cc:
        out = step(*args)
    seconds = time.perf_counter() - t0
    return cc, arg_bytes, _bytes(out), seconds


def probe_depths(cfg: ModelConfig) -> Tuple[int, int]:
    """(k1, k2) probe depths for the depth extrapolation (JAX's choice: the
    stack's pattern repeats an integer number of times where possible)."""
    if cfg.family == "hybrid":
        return (cfg.attn_every, 2 * cfg.attn_every)
    if cfg.first_dense:
        return (cfg.first_dense + 2, cfg.first_dense + 4)
    return (2, 4)


def probe_costs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                step_cfg: StepConfig = StepConfig()
                ) -> roofline.RooflineTerms:
    """Two shallow traces -> depth-extrapolated roofline terms (JAX's
    ``probe_costs``, the port's count in place of XLA's)."""
    k1, k2 = probe_depths(cfg)
    costs = [trace_cell(dataclasses.replace(cfg, n_layers=k), shape, mesh,
                        step_cfg)[0].raw_costs() for k in (k1, k2)]
    return roofline.from_probes(costs[0], costs[1], k1, k2, cfg.n_layers,
                                mesh.size(),
                                roofline.model_flops_for(cfg, shape))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             step_cfg: StepConfig = StepConfig(),
             cfg: ModelConfig | None = None, impl: str = "kernel",
             shape: ShapeSpec | None = None, mesh=None) -> Dict[str, Any]:
    """One cell's row (``shape`` and ``mesh``, where given, in place of
    the named shape and the production mesh)."""
    cfg = cell_config(cfg or get_config(arch), impl)
    shape = shape or SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    cc, arg_bytes, out_bytes, seconds = trace_cell(cfg, shape, mesh,
                                                   step_cfg)
    terms = cc.terms(mesh.size(), roofline.model_flops_for(cfg, shape))
    temp = cc.peak_bytes - cc.argument_bytes
    mem_info = {"argument_size_bytes": arg_bytes,
                "output_size_bytes": out_bytes,
                "temp_size_bytes": temp,
                "generated_code_size_bytes": 0}
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok",
        "n_devices": mesh.size(),
        "lower_s": round(seconds, 1), "compile_s": 0.0,
        "flops": terms.flops, "hbm_bytes": terms.hbm_bytes,
        "coll_bytes_per_dev": terms.coll_bytes,
        "coll_breakdown": terms.coll_breakdown,
        "t_compute": terms.t_compute, "t_memory": terms.t_memory,
        "t_collective": terms.t_collective,
        "bottleneck": terms.bottleneck,
        "model_flops": terms.model_flops,
        "useful_ratio": round(terms.useful_ratio, 4),
        "memory_analysis": mem_info,
        "approx_bytes_per_device_gb": round((arg_bytes + temp) / 2 ** 30, 3),
        "kernels": dict(cc.kernels),
        "flops_by_dtype": dict(cc.flops_by_dtype),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--sp", default=None, choices=["off", "attn", "full"],
                    help="the config's seq_parallel: read for the layout "
                    "JAX would take; the port computes it with the "
                    "sequence whole")
    ap.add_argument("--moe", default=None, choices=["psum", "a2a"],
                    help="MoE dispatch override")
    ap.add_argument("--impl", choices=IMPLS, default="kernel")
    ap.add_argument("--out", default=RESULTS_PATH)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    step_cfg = StepConfig(n_microbatches=args.microbatches)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if r.get("status") in ("ok", "skipped")}

    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                key = (arch, shape_name, "multi" if mp else "single")
                if key in done:
                    print(f"[cached] {key}")
                    continue
                print(f"[dryrun] {key} ...", flush=True)
                try:
                    cfg = get_config(arch)
                    if args.sp:
                        cfg = dataclasses.replace(cfg, seq_parallel=args.sp)
                    if args.moe:
                        cfg = dataclasses.replace(cfg, moe_impl=args.moe)
                    r = run_cell(arch, shape_name, mp, step_cfg, cfg=cfg,
                                 impl=args.impl)
                    if args.sp or args.moe:
                        r["overrides"] = {"sp": args.sp, "moe": args.moe}
                except Exception as e:   # a cell's failure is its row
                    r = {"arch": arch, "shape": shape_name,
                         "mesh": key[2], "status": "error",
                         "error": f"{type(e).__name__}: {e}",
                         "trace": traceback.format_exc()[-2000:]}
                results = [x for x in results
                           if (x["arch"], x["shape"], x["mesh"]) != key]
                results.append(r)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                status = r["status"]
                extra = (f" bottleneck={r.get('bottleneck')} "
                         f"t=({r.get('t_compute', 0):.4f},"
                         f"{r.get('t_memory', 0):.4f},"
                         f"{r.get('t_collective', 0):.4f})s "
                         f"useful={r.get('useful_ratio')} "
                         f"traced in {r.get('lower_s')} s"
                         if status == "ok" else
                         r.get("reason", r.get("error", "")))
                print(f"[{status}] {key} {extra}", flush=True)
                gc.collect()

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"-> {args.out}")
    return results


if __name__ == "__main__":
    main()
