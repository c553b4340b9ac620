"""On-card smoke test of the PyTorch port (repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order, each of which fails the script when it fails:
  1. build the five CUDA kernels from src/repro_torch/kernels/csrc/ (one
     nvcc per source, started together) and print ptxas's registers,
     static shared memory and spills for seg_waterfill's one-launch entry
     points, fw_minplus's two (fw_panels, fw_tiles), place_round's, the
     two LM kernels' tensor-core ones and flash_attention's FP32-pipe ones
     at D 256;
  2. hold the simulator's kernels against their plain PyTorch versions on
     the card, at the main path's shapes and at edge shapes, and time
     both (CUDA events around 10 back-to-back launches, median of 3 such
     runs after warm-up):
     seg_waterfill rates bit for bit and load within rtol 2e-6 (against
     the plain version run on the CPU, which adds in slot order) at
     F = 12000 / E = 2800 (by both variants), F = 8 / E = 5, the paper's
     F = 600 / E = 28, a hot link (every active flow on one link) and
     F = 20000 (the global variant), printing each shape's variant, its
     CUDA launches per call and its dynamic shared memory; timed at
     F = 12000 (both variants), F = 600 and on the hot link, and the
     shared-memory variant at 0, 1 and 8 rounds on those three inputs;
     at P = 6 on the fattree1k-backlog cell's fabric (the k = 16 fat
     tree, E = 3072): F = 30,720 (the global variant) and the largest F
     the shared-memory variant holds there (10,593; by both variants),
     rates and load bit for bit against the plain version, each variant
     timed, the plain version and the bound at F = 30,720;
     the tick's float segment sums on the card bit for bit against the
     CPU: per-link sums on the hot link and on paper flows,
     _free_resources at 2000 hosts / 6000 containers with a third on one
     host;
     fw_minplus bit for bit on dyadic weights at n = 2402, 37, TILE - 1,
     TILE, TILE + 1 and 2 TILE + 1, and on a disconnected graph whose
     unreachable pairs must stay 1e9; rtol 1e-5 on random weights at
     n = 2402; timed at n = 2402, its bound 2 n_pad^3 FP32 instructions
     (an FADD and an FMNMX per relaxation) at the issue peak, SMs x 128
     lanes x the SM clock's maximum from nvidia-smi;
     place_round at K = 64, H = 100 (a burst's fifth tick at Table 7's
     100-host point, 64 candidates) bit for bit against the plain loop in
     chosen, used, slot counts and pointer, both timed; then a 20-tick
     burst episode there with the kernel (one launch a tick) and with the
     plain loop, final states bit-identical; then a 150-tick burst
     telescoped with the kernel (one launch a full tick, fewer full ticks
     than the horizon), its final state bit-identical to the plain loop's
     per tick;
  3. the same for the LM kernels, printing for each shape the variant
     that ran and its CUDA launches per call: flash_attention at the
     zamba2-1.2b prefill shape, a qwen2.5-3b GQA shape (Hq 16, Hkv 2,
     D 128), an edge shape (S below one tile, MQA, f32), a ragged S on the
     tensor-core variant (S 1000), bf16 at D 32 on the FP32-pipe variant
     and paligemma-3b's prefill shape (B 4, S 2048, Hq 8, Hkv 1, D 256,
     bf16, the FP32-pipe variant) — on bf16 outputs every element within 2 bf16 ulps of the
     plain version's plus 1e-5, a limit that the same attention with p or
     the PV accumulator rounded to bf16 must miss at the zamba2 shape (the
     controls); rtol/atol 1e-5 on f32 — timed at the zamba2, qwen2.5 and
     D 256 shapes with SDPA beside it as the library yardstick; ssd_scan at the
     zamba2-1.2b shape, the mamba2-1.3b shape (N 128) and a one-chunk
     ragged edge — within rtol/atol 1e-4;
  4. the paper experiment: the six policies at 20 hosts / 300 containers,
     horizon 120, kernels 'auto' (a place_round launch a tick), each
     completing 300/300 (ticks/s printed) and agreeing with the port's CPU
     run (plain versions) leaf by leaf;
  4a. ML jobs through core/bridge.py: examples/schedule_training_
     cluster.py's fallback jobs (3 jobs x 6 workers) on its testbed (paper
     hosts, the Fig 3 fabric at bw 10000, horizon 220) for round,
     performance_first, jobgroup and netaware: one seg_waterfill launch a
     tick, the card against the port's CPU run as in phase 4;
  5. the simulator's main path at real size: 2000 hosts / 6000
     containers, 'fw' delay refresh, policy netaware, horizon 40 — launch
     counts reset just before and read just after (a place_round launch
     a tick), ticks/s and peak device memory printed; then the same run
     again, whose final state must be bit-identical;
  5a. the same run streamed (ExecPlan(chunk=16): chunks of 16 + 16 + 8,
     a refresh inside a chunk): final state bit-identical to phase 5's,
     its OnlineSummary equal to online_from_metrics of phase 5's series
     (integers exactly, floats within rtol 3e-6), 40 seg_waterfill, 4
     fw_minplus and 40 place_round launches counted; then streamed and stacked timed in
     turns (streamed, stacked, stacked, streamed, twice), each run's
     ticks/s and peak device memory above its start printed; then the
     fold alone: acc_update's host ms a tick and online_fold's a chunk;
  5b. the policy sweep at the JAX package's tracked sweep point
     (benchmarks/engine_bench.py QUICK_SWEEP and bench_scenarios: 50
     hosts, 300 containers, horizon 40, the six policies x baseline,
     slow_net, lossy_net, tight x one seed = 24 cells), 'fw' refresh,
     streamed with chunk 16 and slab 5 (the last slab holds 4 cells):
     the launches counted (40 seg_waterfill and 4 fw_minplus a cell);
     the first, a middle and the last cell re-run standalone through
     run_sim, stacked and streamed, finals bit-identical and summary rows
     equal (integers exactly, floats within rtol 3e-6); wall time (the
     scenarios' build apart), cells/s and peak device memory printed;
     each of those three cells timed through the sweep's runner
     (iter_slabs, slab 1) and standalone (run_sim, chunk 16) in turns;
     then run_tune, 4 samples over the baseline scenario at 20 hosts,
     horizon 20, every score finite;
  5e. the multi-process sweep fabric on the card (launch.dist): (i) phase
     5b's sweep through run_dist_sweep with 2 worker processes sharing
     the card (ExecPlan(chunk=16, slab=5, procs=2), the TCP slab handout
     and the gloo group): finals and summary bit-identical to phase 5b's,
     the workers' summed launches 40 seg_waterfill and 4 fw_minplus a
     cell, every slab claimed once, each worker meta naming the card;
     cells/s beside phase 5b's, each worker's start-up time and slab
     walls, and the coordinator's stragglers printed; (ii) a resume with
     devices_per_proc=2 (each worker holds cuda:0 twice, slab 5 pads to
     6) over 2 policies x the 4 scenarios: the first slab written in
     this process and its worker meta removed (an orphan), the rest by
     2 spawned workers, the merge bit-identical to the in-process sweep
     at that plan (ExecPlan(devices=(cuda:0, cuda:0))); (iii) phase 5b's
     4-sample tune, streamed (chunk 10) with procs=2: scores equal to
     phase 5b's. A worker that fails fails the phase;
  5c. soft placement and its gradient (make_grad_fn, torch autograd; the
     kernels forward only): the paper testbed (Table 5 hosts, Fig 3
     fabric, Table 6 workload, 300 containers, horizon 40, 'fw', tau 1)
     under baseline and slow_net (bw 200) with netaware's weights plus the
     JAX package's finite-difference offsets (rng 11, uniform 0.05-0.4 on
     row_comm, row_coloc, row_worst_fit, row_cross_leaf), stacked, on
     the card against the port's CPU run: values within rtol 1e-5,
     gradients rtol 1e-4 / atol 1e-6, the hard finals as phase 4 compares
     them; then phase 5's run with the flag on: the soft forward under
     no_grad against the flag-off run in four turn pairs (hard finals and
     metrics bit-identical to phase 5's; wall and peak memory printed), the
     offset weights' stacked gradient twice (finite, nonzero on row_comm,
     bit-identical), the same cell's forward and backward timed apart
     (the gradient bit-identical again; the backward's share printed),
     and the chunked gradient (chunk 16: value within rtol 1e-5, gradient
     within rtol 1e-4 / atol 1e-7 off util and cross_leaf); 40
     seg_waterfill and 4 fw_minplus launches a pass (and 40 place_round
     in the flag-off runs; the soft round keeps the plain loop); then run_tune_grad
     (6 steps x 4 candidates, eval every 3, lr 0.3) on the JAX test's
     small config under slow_net: the best oracle score finite and no
     worse than the incumbent's, its wall time printed;
  5d. event-horizon telescoping (ExecPlan(telescope=True)), the engine
     metered (its macro steps, the cheap ticks it takes and their host
     time): (i) phase 5's run telescoped: final state bit-identical to
     phase 5's, its OnlineSummary equal to online_from_metrics of phase
     5's series (integers exactly, floats within rtol 3e-6), one
     seg_waterfill and one place_round launch a full tick and 4
     fw_minplus, the full ticks
     and ticks/s printed; (ii) the drained tail: the same fleet and
     workload over horizon 400, a refresh every 100, chunks of 128,
     streamed per tick and telescoped in turns (per tick, telescoped,
     telescoped, per tick): finals bit-identical, summaries equal as
     above, 4 fw_minplus a run and one seg_waterfill and one
     place_round a full tick, fewer
     full ticks than the horizon; each run's ticks/s, the full ticks,
     the host time a cheap tick and the quiescence test's a full tick
     printed;
  6. reduced zamba2 served on the card (kernels) against the port's CPU
     run (plain versions) from the same weights and prompts: prefill and
     decode logits within 4 bf16 ulps of their largest magnitude while
     the tokens agree, tokens equal wherever the CPU's top-2 margin
     exceeds twice that;
  6a. the reduced olmoe-1b-7b, paligemma-3b, musicgen-large (kernels) and
     deepseek-v2-236b (MLA: impl 'ref') on the card against the port's
     CPU run: the card's greedy run counts its launches (a flash_attention
     a layer in the prefill, none with 'ref', none in decode); then,
     teacher forced with the CPU run's tokens and its routing replayed
     (a choice that differs must be a near tie of the router logits),
     logits within 4 bf16 ulps and tokens equal as in phase 6;
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
     bit-identical;
  7a. the same for olmoe-1b-7b (64 experts, top 8; 16 flash_attention
     launches a prefill), paligemma-3b (256 patch embeddings + 1792
     tokens, D 256; 18) and musicgen-large (frame embeddings; 48) as
     published, batch 4, and deepseek-v2-236b at its published widths cut
     to 3 layers (the dense one + 2 moe; 160 experts, top 6, MLA; impl
     'ref': 0), batch 2 — weights GiB, prefill ms and its analytic FLOPs,
     decode tok/s, peak memory and the share of assignments dropped at
     capacity printed; the plain-version prefill routed as the kernels'
     run (a differing choice must be a tie of the router logits within 8
     ulps) within 8 ulps; a second run bit-identical;
  9. training on one card (before phase 8, so that no profiler session
     precedes it; its wall time printed): (i) FlashAttentionFn and
     SSDScanFn at the zamba2-1.2b shapes: forward equal to the raw
     kernel's and gradients equal to the plain version's autograd on the
     card (flash_attention_ref; the model's ssd_chunked_ref) bit for bit,
     a raw wrapper given an input that requires grad raises, forward and
     forward + backward timed; (ii) reduced smollm-360m and zamba2-1.2b,
     3 AdamW steps on the card (kernels) and on the CPU (plain versions)
     from one state and the same SyntheticLM batches: each loss within
     rtol 1e-3, the CPU parity tests' tolerance; (iii) launch.train on
     reduced zamba2 with a checkpoint every 2 steps, its last checkpoint
     removed, rerun: restored at step 2, final state bit-identical to the
     uninterrupted 4 steps; (iv) zamba2-1.2b as published, batch 4, seq
     2048, remat on, AdamW on f32 masters, SyntheticLM(seed 0), 4 steps
     from init_train_state(seed=0), launch counts reset before step 1
     (12 flash_attention and 76 ssd_scan launches a step: forward and
     remat rerun), each step's loss and grad norm finite and printed with
     its ms, the median of steps 2-4, tokens/s and peak memory; one step
     with impl 'ref' from the same state (loss within rtol 1e-3); a
     second run: losses, grad norms and final parameters bit-identical;
  10. training the moe family and MLA, and the mesh path (after phase 9,
     its wall time printed): (i) reduced olmoe-1b-7b (kernels) and
     deepseek-v2-236b (MLA: impl 'ref'), batch 4 x 64, 3 AdamW steps on
     the card and on the CPU from one state, the card's routing held to
     the CPU run's (the first step at moe.NEAR_TIE_ULPS, later ones at
     STEP_TIE_ULPS: after AdamW's first update the runs' parameters
     differ), each loss within rtol 1e-3, 2 flash_attention launches a
     layer a step, a second card run bit-identical; (ii) olmoe-1b-7b at
     its published widths cut to 4 of 16 layers (one card's 80 GB),
     batch 4 x 2048, remat, AdamW on f32 masters, SyntheticLM(seed 0), 4
     steps from init_train_state(seed=0), launch counts reset before step
     1 (8 flash_attention launches a step), step ms (median of steps
     2-4), tokens/s, peak memory and the share of assignments dropped at
     capacity printed, a second run bit-identical; (iii) MESH_WORKERS
     (2) processes sharing the card over gloo (NCCL refuses two ranks on
     one device; each is this script run with --mesh-worker), reduced
     olmoe on the (1, 2) mesh with moe_impl 'psum' and 'a2a': the
     gradient (every leaf within 8 bf16 ulps of its largest magnitude,
     cosine >= 0.999) and 2 steps' losses (rtol 1e-3) on the card against
     the same mesh's run with the state on the CPU;
  11. serving on a mesh and the dry run against the card (after phase
     10, its wall time printed): (i) SERVE_WORKERS (2) processes sharing
     the card over gloo (each is this script run with --serve-worker),
     reduced olmoe-1b-7b and zamba2-1.2b (kernels) on the (1, 2) mesh,
     batch 4 x 64, prefill and 8 decode steps on the card (fed the CPU
     run's tokens, routed as it) against the CPU run at the same mesh:
     each rank's logits within MODEL_ULPS, tokens equal where the CPU's
     top-2 margin is clear, flash_attention and ssd_scan launches per
     rank printed; (ii) launch/dryrun.py's count at the (1, 1)
     shape-only mesh of zamba2-1.2b's prefill (batch 4 x 2048, f32
     weights, as the dry run takes them) and training step and of
     olmoe-1b-7b's at 4 of 16 layers, beside the same step on the card
     at the host mesh: the count's bound max(t_compute, t_memory) must
     not beat the measured time (median of 3 steps), and the card's peak
     of a step over the count's argument + temp must lie in MEMORY_RATIO
     (0.8-1.25); (iii) ``python -m repro_torch.launch.dryrun --all
     --mesh single`` in a process of its own beside (i) and (ii): no row
     in error, every status as cell_is_runnable, its wall time printed
     (--mesh single: both meshes took over the 3 minutes allowed);
  8. seg_waterfill's device events per call of each variant at F = 12000
     and of the variant the wrapper picks on phase 2's two six-link
     shapes under torch.profiler (20 calls each), with each event's
     device time:
     the shared-memory variant must be one kernel and no memset, the
     global one four kernels and two memsets; fw_minplus's at n = 2402 (10
     calls): two kernels per pivot block (76) and no memset (last, so that
     no profiler session precedes the timed phases).
The last lines are the script's wall time, the card's name and power
limit, one JSON line of kernel measurements (flash_attention's and
ssd_scan's launches: phases 7, 7a, 9 (iv) and 10 (ii) summed;
seg_waterfill's and fw_minplus's: phase 5's; place_round's: phase 2's
burst episode), and the result line.
Imports torch and repro_torch only.  Exits non-zero without a CUDA
device.
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
import tempfile
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

from repro_torch.core import (ExecPlan, SimConfig,  # noqa: E402
                              build_paper_hosts, build_paper_network,
                              get_policy, init_sim, list_policies,
                              online_from_metrics, paper_workload, run_sim,
                              scaled_hosts, summarize)
from repro_torch.core import engine, network, stats  # noqa: E402
from repro_torch.core.convert import assert_state_close  # noqa: E402
from repro_torch.core.scenario import (ScenarioSpec,  # noqa: E402
                                       build_scenarios)
from repro_torch.core.scheduling import weight_index  # noqa: E402
from repro_torch.core.types import (OnlineSummary,  # noqa: E402
                                    PolicyParams, TickMetrics, tree_map)
from repro_torch.kernels import (LAUNCHES, _build,  # noqa: E402
                                 reset_launch_counts)
from repro_torch.kernels.fw_minplus import (floyd_warshall,  # noqa: E402
                                            floyd_warshall_ref)
from repro_torch.kernels.place_round import (place_round,  # noqa: E402
                                             place_round_ref)
from repro_torch.kernels.seg_waterfill import (seg_waterfill,  # noqa: E402
                                               seg_waterfill_ref)
from repro_torch.launch.profile import device_summary  # noqa: E402
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, the dense TF32
# tensor-core rate (ssd_scan's f32 inputs, whose products run on the tensor
# cores) and the dense bf16 tensor-core rate (the type of flash_attention's
# inputs on the model path); bound_ms defaults to the FP32 rate outside the
# tensor cores (the simulator's kernels compute in f32)
from repro_torch.core.h100 import (  # noqa: E402
    HBM_BW, PEAK_FLOPS, PEAK_TF32_PER_S)
# the kernels' work and the prefill's FLOPs, which the dry run counts with too
from repro_torch.launch.roofline import (  # noqa: E402
    bound_ms, flash_work, n_moe_layers, prefill_flops, ssd_work)
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
sw_mod = importlib.import_module(  # the module, not the wrapper function
    "repro_torch.kernels.seg_waterfill.seg_waterfill")
fw_mod = importlib.import_module("repro_torch.kernels.fw_minplus.fw_minplus")
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BF16_ATOL, BF16_ULPS, bf16_limit_share, flash_attention,
    flash_attention_ref)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref  # noqa: E402
from repro_torch.launch.serve import prompt_batch, serve  # noqa: E402
from repro_torch.launch.sweep import (make_grad_fn,  # noqa: E402
                                      make_stream_fn, make_sweep_fn,
                                      run_sweep, stack_policies)
from repro_torch.launch.tune import run_tune, run_tune_grad  # noqa: E402
from repro_torch.launch.dist import (GridSpec, run_dist_sweep,  # noqa: E402
                                     run_spec, run_worker_inline)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.core import bridge  # noqa: E402
from repro_torch.serve.step import (all_rows,  # noqa: E402
                                    make_decode_step, start)
from repro_torch.serve.step import init_params as serve_init_params  # noqa: E402
from repro_torch.data.pipeline import (DataConfig,  # noqa: E402
                                       SyntheticLM, to_device)
from repro_torch.kernels.flash_attention import FlashAttentionFn  # noqa: E402
from repro_torch.kernels.ssd_scan import SSDScanFn  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.ssm import ssd_chunked_ref  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.step import (init_train_state,  # noqa: E402
                                    make_train_step)

DEV = torch.device("cuda")
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


def entry_label(line):
    """The readable name of the entry point a ptxas "Compiling entry
    function" line names, or None for another line."""
    m = re.search(r"Compiling entry function '\S*?waterfill_smemILi(\d+)E",
                  line)
    if m:
        return f"waterfill_smem<{m.group(1)}>"
    m = re.search(r"Compiling entry function '\S*?(fw_[a-z0-9]+)E", line)
    if m:
        return m.group(1)
    if "place_round_kernel" in line:
        return "place_round_kernel"
    m = re.search(r"Compiling entry function '\S*?((?:flash_fwd|ssd)_"
                  r"[a-z0-9]+?)(?:I(.*?)EE)?E", line)
    if m:
        args = (m.group(2) or "").replace("13__nv_bfloat16", "bf16,")
        args = re.sub(r"^f", "float,", args).replace("Li", "")
        return m.group(1) + (f"<{args.strip(',')}>" if args else "")
    return None


def ptxas_report(name):
    """One line per entry point of kernel ``name``'s build in this process
    that chip_smoke reports (the LM kernels' tensor-core ones and the
    FP32-pipe flash_fwd_fp32 at D 256, whose 4 x 16 accumulators a thread
    are its register risk; seg_waterfill's one-launch ones; both of
    fw_minplus), from
    ptxas's ``-Xptxas -v`` report: registers, static shared memory (the
    kernels take theirs dynamically, at launch), stack and spills."""
    out, label = {}, None
    for line in _build.BUILD_LOGS.get(name, "").splitlines():
        if "Compiling entry function" in line:
            label = entry_label(line)
            if label and (not label.startswith("flash_fwd_fp32")
                          or label.endswith(",256>")):
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


def main_path_flows(net, n_hosts, F, seed):
    """F flows between random hosts of ``net``, routed on its paths as
    network.flow_rates routes them (inactive flows all -1), with a Mathis
    cap on 30% of them: (links [F,P] i32, P the fabric's path width,
    active [F] bool, link_bw_kbps [E], tcp_cap [F])."""
    r = np.random.default_rng(seed)
    src = torch.tensor(r.integers(0, n_hosts, F), device=DEV)
    dst = torch.tensor(r.integers(0, n_hosts, F), device=DEV)
    active = torch.tensor(r.uniform(size=F) < 0.8, device=DEV)
    links = torch.where(active[:, None], net.path_links[src, dst], -1)
    tcp = torch.where(torch.tensor(r.uniform(size=F) < 0.3, device=DEV),
                      torch.tensor(r.uniform(10, 1e4, F), dtype=torch.float32,
                                   device=DEV), 1e9).float()
    return links.int().contiguous(), active, net.link_bw_kbps, tcp


def hot_link_flows(F, E, seed):
    """F flows over E links in which every active flow crosses link 0
    (its first slot), the rest of each path random: link 0's list is
    about 0.8 F long, far above the warp-walk threshold."""
    r = np.random.default_rng(seed)
    links = r.integers(1, E, (F, 4)).astype(np.int32)
    links[np.arange(4)[None, :] >= r.integers(1, 5, F)[:, None]] = -1
    links[:, 0] = 0
    active = r.uniform(size=F) < 0.8
    links[~active] = -1
    bw = r.uniform(1e5, 1e6, E).astype(np.float32)
    tcp = np.where(r.uniform(size=F) < 0.3, r.uniform(10, 1e4, F),
                   1e9).astype(np.float32)
    return tuple(torch.tensor(x, device=DEV) for x in (links, active, bw, tcp))


# each seg_waterfill variant, launched by name (the wrapper picks by size)
WATERFILL_VARIANTS = {"smem": sw_mod._launch_smem,
                      "global": sw_mod._launch_global}


def device_events(fn, calls):
    """({device event name: (ms per call, events per call)}, busy ms per
    call) of ``calls`` back-to-back calls of ``fn`` under the profiler:
    the kernels and memsets they launched, PyTorch's fills of
    uninitialised outputs in deterministic mode included.  Busy time is
    the union of the events' spans, which overlap where a launch starts
    while the one before drains (programmatic dependent launch)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    _, kernels, _ = device_summary(prof.events())
    short = (re.sub(r"\(.*", "", n.replace("void ", "")
                    .replace("(anonymous namespace)::", "")).strip()
             for n in kernels)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return ({k: (ms / calls, c / calls)
             for k, (ms, c) in zip(short, kernels.values())},
            busy / 1e3 / calls)


def check_waterfill(real_net, n_hosts):
    """seg_waterfill on each shape by the variant variant(F, E) picks (and
    the global one on the main shape) against its plain version on the
    same inputs: rates bit for bit, load within rtol 2e-6; the launches of
    one call; times.  The plain version runs on the CPU for the comparison
    (the contract is each link's sum in ascending slot order, which
    network.segment_sum keeps on both devices); its time is taken on the
    card.  Returns the kernels row."""
    E = real_net.link_bw_kbps.shape[0]
    main = main_path_flows(real_net, n_hosts, 12000, seed=1)
    _, paper_net = build_paper_network(SimConfig(), device=DEV)
    paper = main_path_flows(paper_net, 20, 600, seed=7)
    hot = hot_link_flows(12000, E, seed=5)
    errs = []
    for name, args, which in (
            (f"F=12000,E={E}", main, None),
            (f"F=12000,E={E}", main, "global"),
            ("F=8,E=5", random_flows(8, 5, seed=2), None),
            ("paper F=600,E=28", paper, None),
            (f"hot link F=12000,E={E}", hot, None),
            (f"F=20000,E={E}", main_path_flows(real_net, n_hosts, 20000,
                                               seed=6), None)):
        F, n_links = args[0].shape[0], args[2].shape[0]
        if which is None:
            which, (rk, lk) = sw_mod.variant(F, n_links), seg_waterfill(*args)
        else:
            rk, lk = WATERFILL_VARIANTS[which](*args)
        rk, lk = rk.cpu(), lk.cpu()
        rr, lr = seg_waterfill_ref(*(a.cpu() for a in args))
        if not torch.equal(rk, rr):
            raise AssertionError(f"seg_waterfill {name} ({which}): rates "
                                 f"differ, max {(rk - rr).abs().max().item()}")
        torch.testing.assert_close(lk, lr, rtol=2e-6, atol=1e-3)
        errs.append(max((rk - rr).abs().max().item(),
                        (lk - lr).abs().max().item()))
        n_launch = sw_mod.CUDA_LAUNCHES_PER_CALL[which]
        how = (f"variant smem, {n_launch} CUDA launch per call, "
               f"{sw_mod.smem_bytes(F, n_links)} bytes of dynamic shared "
               f"memory" if which == "smem" else
               f"variant global, {n_launch} CUDA launches and 2 memsets per "
               f"call, workspace in device memory")
        log(f"seg_waterfill {name} ({how}): rates bit-exact, load "
            f"{'bit-exact' if torch.equal(lk, lr) else 'within rtol 2e-6'}")
    ms = time_ms(lambda: seg_waterfill(*main))
    ms_global = time_ms(lambda: sw_mod._launch_global(*main))
    ms_paper = time_ms(lambda: seg_waterfill(*paper))
    ms_hot = time_ms(lambda: seg_waterfill(*hot))
    plain = time_ms(lambda: seg_waterfill_ref(*main))
    links, active, bw, tcp = main
    n_bytes = sum(t.numel() * t.element_size() for t in main) + 4 * (
        links.shape[0] + E)
    b, by = bound_ms(n_bytes, waterfill_ops(links, active, E))
    log(f"seg_waterfill F=12000 E={E}: kernel {ms:.4f} ms (variant smem; "
        f"the global variant {ms_global:.4f} ms), plain {plain:.4f} ms, "
        f"bound {b:.6f} ms ({by}); paper F=600 E=28 {ms_paper:.4f} ms; hot "
        f"link {ms_hot:.4f} ms")
    # the smem variant by rounds: at 0 the CSR build, tail and load alone
    for name, args in (("F=12000", main), ("hot link", hot),
                       ("paper F=600", paper)):
        by_rounds = ", ".join(
            f"{n} {time_ms(lambda: seg_waterfill(*args, n_rounds=n)):.4f}"
            for n in (0, 1, 8))
        log(f"seg_waterfill {name} ms by n_rounds: {by_rounds}")
    return dict(
        name="seg_waterfill", route="cuda",
        source="src/repro_torch/kernels/csrc/seg_waterfill.cu",
        replaces="src/repro/kernels/seg_waterfill/seg_waterfill.py:190",
        variant=sw_mod.variant(12000, E), max_abs_err=max(errs), ms=ms,
        plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)


def six_link_inputs():
    """seg_waterfill's inputs on the fattree1k-backlog cell's fabric (the
    k = 16 fat tree: 1024 hosts, E = 3072 links, paths of 2, 4 and 6
    links, network.FatTreeSpec): {name: (args, variant)} at the cell's
    F = 30,720 flow slots (the global variant) and at the largest F the
    shared-memory variant holds at P = 6 over those links."""
    spec = network.FatTreeSpec(k=16)
    net = network.build_network(spec, device=DEV)
    H, E = spec.n_hosts, spec.n_links
    f_smem = (sw_mod.SMEM_LIMIT - sw_mod.smem_bytes(0, E, 6)) // (2 * 6 + 5)
    assert sw_mod.variant(f_smem, E, 6) == "smem"
    assert sw_mod.variant(f_smem + 1, E, 6) == "global"
    assert sw_mod.variant(30720, E, 6) == "global"
    return {f"P=6 F=30720,E={E}": (main_path_flows(net, H, 30720, seed=11),
                                   "global"),
            f"P=6 F={f_smem},E={E}": (main_path_flows(net, H, f_smem,
                                                      seed=12), "smem")}


def check_waterfill_six_links():
    """seg_waterfill at P = 6 (six_link_inputs): each shape through the
    wrapper and by each variant that takes it (the global one takes
    both) against the plain version run on the CPU on the same inputs,
    rates and load bit for bit; the wrapper's variant and its launches;
    both variants timed, the plain version at F = 30,720 on the card, and
    the bound at F = 30,720.  Returns the seg_waterfill row's
    ``six_links`` entry."""
    out = {}
    for name, (args, picked) in six_link_inputs().items():
        F, P = args[0].shape
        E = args[2].shape[0]
        assert P == 6 and int((args[0] >= 0).sum(1).max()) == 6
        assert sw_mod.variant(F, E, P) == picked
        rr, lr = seg_waterfill_ref(*(a.cpu() for a in args))
        runs = {"wrapper": seg_waterfill}
        runs.update({w: WATERFILL_VARIANTS[w] for w in
                     ("smem", "global") if w == picked or w == "global"})
        for how, fn in runs.items():
            before = LAUNCHES["seg_waterfill"]
            rk, lk = (t.cpu() for t in fn(*args))
            assert LAUNCHES["seg_waterfill"] == before + 1
            if not (torch.equal(rk, rr) and torch.equal(lk, lr)):
                raise AssertionError(
                    f"seg_waterfill {name} ({how}): differs from the plain "
                    f"version, rates max {(rk - rr).abs().max().item()}, "
                    f"load max {(lk - lr).abs().max().item()}")
        times = {w: time_ms(lambda: WATERFILL_VARIANTS[w](*args))
                 for w in runs if w != "wrapper"}
        row = dict(variant=picked,
                   launches=sw_mod.CUDA_LAUNCHES_PER_CALL[picked],
                   smem_bytes=sw_mod.smem_bytes(F, E, P), ms=times[picked],
                   **{f"ms_{w}": t for w, t in times.items()})
        links, active, _, _ = args
        if F == 30720:
            n_bytes = sum(t.numel() * t.element_size() for t in args) \
                + 4 * (F + E)
            row["bound_ms"], row["bound_by"] = bound_ms(
                n_bytes, waterfill_ops(links, active, E))
            row["plain_ms"] = time_ms(lambda: seg_waterfill_ref(*args))
        out[name] = row
        log(f"seg_waterfill {name}: the wrapper picks variant {picked} "
            f"({row['launches']} CUDA launch(es) a call"
            f"{', 2 memsets' if picked == 'global' else ''}); "
            f"{' and '.join(w for w in runs if w != 'wrapper')} bit for bit "
            f"against the plain version (rates and load); "
            + ", ".join(f"{w} {t:.4f} ms" for w, t in times.items())
            + (f"; plain {row['plain_ms']:.4f} ms, bound "
               f"{row['bound_ms']:.6f} ms ({row['bound_by']})"
               if "bound_ms" in row else ""))
    return out


def check_waterfill_launches(real_net, n_hosts, calls=20):
    """Phase 8: the device events of each seg_waterfill variant at
    F = 12000, and at P = 6 on six_link_inputs' shapes, under
    torch.profiler, per call over ``calls`` calls: the shared-memory
    variant must be one kernel and no memset, the global one four
    kernels and two memsets; prints each event's device time.  Last, so
    that no profiler session precedes the timed phases."""
    main = main_path_flows(real_net, n_hosts, 12000, seed=1)
    cases = [("F=12000", main, "smem", 1, 0),
             ("F=12000", main, "global", 4, 2)]
    for name, (args, picked) in six_link_inputs().items():
        cases += [(name, args, picked, 1, 0) if picked == "smem" else
                  (name, args, "global", 4, 2)]
    for name, args, which, want_kernels, want_memsets in cases:
        events, _ = device_events(
            lambda: WATERFILL_VARIANTS[which](*args), calls)
        ours = sum(c for n, (_, c) in events.items()
                   if "waterfill" in n or n.startswith("csr_"))
        memsets = sum(c for n, (_, c) in events.items() if "Memset" in n)
        if (ours, memsets) != (want_kernels, want_memsets):
            raise AssertionError(f"seg_waterfill {name} {which}: device "
                                 f"events per call {events}")
        total = sum(ms for ms, _ in events.values())
        split = "; ".join(f"{n} {ms:.4f} ms x{c:g}" for n, (ms, c) in
                          sorted(events.items(), key=lambda r: -r[1][0]))
        log(f"seg_waterfill {name} variant {which}: device events per call "
            f"over {calls} calls, {total:.4f} ms in all: {split}")


def free_inputs(device):
    """engine._free_resources at real size: 2000 hosts, 6000 containers
    with paper_workload's requests (uniform draws, not dyadic), a third of
    them on host 7, about 80% of them freed.  The same as the test module's
    (tests/test_torch_kernels.py), which is not imported here: it sets
    torch to one CPU thread, and phases 4 and 6 run on the CPU."""
    H, C = 2000, 6000
    req = paper_workload(SimConfig(n_jobs=C // 3, n_tasks=C, n_containers=C),
                         seed=0, device=device).req
    r = np.random.default_rng(3)
    host = r.integers(-1, H, C)
    host[r.uniform(size=C) < 1 / 3] = 7
    mask = r.uniform(size=C) < 0.8
    hosts = scaled_hosts(H, H // 5, device=device)
    hosts = hosts._replace(used=hosts.cap * 0.75, n_containers=torch.full(
        (H,), C, dtype=torch.int32, device=device))
    return (hosts, req, torch.tensor(host, dtype=torch.int32, device=device),
            torch.tensor(mask, device=device))


def check_segment_sums(paper_net, E):
    """The float segment sums of the tick on the card against the same
    call on the CPU, bit for bit: the per-link sums on the hot-link input
    (a run of ~9600 slots on link 0) and on paper flows, and
    _free_resources at real size."""
    for name, (links, active, bw, tcp) in (
            ("hot link F=12000", hot_link_flows(12000, E, seed=5)),
            ("paper F=600", main_path_flows(paper_net, 20, 600, seed=7))):
        n_links = bw.shape[0]
        valid = (links >= 0) & active.bool()[:, None]
        seg = torch.where(valid, links, n_links).reshape(-1).long()
        w = (tcp[:, None] * valid.float()).reshape(-1)
        card = network.segment_sum(w, seg, n_links).cpu()
        cpu = network.segment_sum(w.cpu(), seg.cpu(), n_links)
        if not torch.equal(card, cpu):
            raise AssertionError(f"segment_sum {name}: card differs "
                                 f"from the CPU, max "
                                 f"{(card - cpu).abs().max().item()}")
        log(f"segment_sum per link, {name}: card equals the CPU bit for "
            f"bit")
    ins = free_inputs(DEV)
    card = engine._free_resources(*ins)
    cpu = engine._free_resources(*free_inputs("cpu"))
    if not (torch.equal(card.used.cpu(), cpu.used)
            and torch.equal(card.n_containers.cpu(), cpu.n_containers)):
        raise AssertionError("_free_resources at real size: card differs "
                             "from the CPU")
    log(f"_free_resources 2000 hosts / 6000 containers "
        f"({int(((ins[2] == 7) & ins[3]).sum())} freed on one host): card "
        f"equals the CPU bit for bit")


def disconnected(n, seed):
    """A dyadic graph of two components (nodes drawn at random into
    either), so every pair across them stays unreachable; and the mask
    of those pairs."""
    A = adjacency(n, seed, True)
    comp = torch.tensor(np.random.default_rng(seed).integers(0, 2, n),
                        device=DEV)
    apart = comp[:, None] != comp[None, :]
    return A.masked_fill(apart, 1e9), apart


def fp32_issue_peak():
    """This card's FP32 issue peak in lane-instructions a second, SMs x
    128 lanes x the SM clock's maximum from nvidia-smi, and that clock in
    MHz: an FADD and an FMNMX are one lane-instruction each."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    return sms * 128 * mhz * 1e6, mhz


def check_fw():
    """fw_minplus against its plain version on the card: bit for bit on
    dyadic weights (at the main path's n = 2402, at n = 37 and one tile
    edge below, at and above one tile and above two), rtol 1e-5 on random
    weights, unreachable pairs of a disconnected graph at 1e9.  Returns
    the kernels row."""
    n, T = 2402, fw_mod.TILE
    errs = []
    cases = [("n=2402 dyadic", adjacency(n, 3, True), True),
             ("n=2402 random", adjacency(n, 4, False), False),
             ("n=37 dyadic", adjacency(37, 5, True), True)]
    cases += [(f"n={m} dyadic", adjacency(m, m, True), True)
              for m in (T - 1, T, T + 1, 2 * T + 1)]
    A_apart, apart = disconnected(2 * T + 1, 6)
    cases.append((f"n={2 * T + 1} disconnected", A_apart, True))
    for name, A, exact in cases:
        Dk, Dr = floyd_warshall(A), floyd_warshall_ref(A)
        torch.cuda.synchronize()
        if exact and not torch.equal(Dk, Dr):
            raise AssertionError(f"fw_minplus {name}: not bit-exact, max "
                                 f"{(Dk - Dr).abs().max().item()}")
        torch.testing.assert_close(Dk, Dr, rtol=1e-5, atol=1e-4)
        errs.append((Dk - Dr).abs().max().item())
        extra = ""
        if A is A_apart:
            if not bool((Dk[apart] == 1e9).all()):
                raise AssertionError("fw_minplus: an unreachable pair left "
                                     "1e9")
            extra = f", its {int(apart.sum())} unreachable pairs at 1e9"
        k = fw_mod.cuda_launches(A.shape[0])
        log(f"fw_minplus {name} ({k} CUDA launch{'es' if k > 1 else ''} per "
            f"call): "
            f"{'bit-exact' if exact else 'within rtol 1e-5'}{extra}")
    A = adjacency(n, 4, False)
    ms = time_ms(lambda: floyd_warshall(A))
    plain = time_ms(lambda: floyd_warshall_ref(A))
    n_pad = -(-n // T) * T
    peak, mhz = fp32_issue_peak()
    # n_pad^3 relaxations, each an FADD and an FMNMX
    relax = float(n_pad) ** 3
    t_ops = 2 * relax / peak * 1e3
    t_bytes = 2 * 4 * n * n / HBM_BW * 1e3
    b, by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                  else "bytes")
    log(f"fw_minplus n={n}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {b:.6f} ms ({by}; 2 n_pad^3 = {2 * relax:.4g} FP32 "
        f"instructions at {peak:.4g}/s, SM clock {mhz:g} MHz)")
    return dict(
        name="fw_minplus", route="cuda",
        source="src/repro_torch/kernels/csrc/fw_minplus.cu",
        replaces="src/repro/kernels/fw_minplus/fw_minplus.py:100",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b,
        bound_by=by, library_ms=None)


def fw_split(calls=10, n=2402):
    """fw_minplus's device events per call at n nodes under torch.profiler,
    printed with their device times; returns (the kernel's launches, the
    memsets) per call."""
    A = adjacency(n, 4, False)
    events, busy = device_events(lambda: floyd_warshall(A), calls)
    ours = sum(c for k, (_, c) in events.items() if k.startswith("fw_"))
    memsets = sum(c for k, (_, c) in events.items() if "Memset" in k)
    total = sum(ms for ms, _ in events.values())
    split = "; ".join(f"{k} {ms:.4f} ms x{c:g}" for k, (ms, c) in
                      sorted(events.items(), key=lambda r: -r[1][0]))
    log(f"fw_minplus n={n}: device events per call over {calls} calls, "
        f"{total:.4f} ms of event spans, the device busy {busy:.4f} ms "
        f"(spans overlap where a launch waits on the one before): {split}")
    return ours, memsets


def check_fw_launches():
    """Phase 8: fw_minplus at n = 2402 must be two kernels per pivot block
    and no memset (the wrapper's pad is PyTorch's fill and copies)."""
    ours, memsets = fw_split()
    want = fw_mod.cuda_launches(2402)
    if ours != want or memsets:
        raise AssertionError(f"fw_minplus: {ours:g} kernels and {memsets:g} "
                             f"memsets per call, want {want} and none")


def burst_100(horizon):
    """Table 7's 100-host point (Table 5 hosts, 20 leaves, 1500 containers
    of Table 6) with its arrivals packed into 4 s, 'fw', netaware: more
    candidates than an admit round's 64 from the first tick."""
    H, C = 100, 1500
    cfg = SimConfig(n_jobs=C // 3, n_tasks=C, n_containers=C,
                    arrival_window=4.0, horizon=horizon, delay_mode="fw")
    spec, net = build_paper_network(cfg, n_hosts=H, n_leaf=H // 5,
                                    device=DEV)
    sim0 = init_sim(scaled_hosts(H, H // 5, device=DEV),
                    paper_workload(cfg, seed=0, device=DEV), net)
    return cfg, spec, sim0, get_policy("netaware", device=DEV)


@contextlib.contextmanager
def plain_admit_loop():
    """Inside the block the engine's admit round runs the plain loop: the
    engine looks ``place_round`` up in its package on every round."""
    import repro_torch.kernels.place_round as pr
    saved, pr.place_round = pr.place_round, place_round_ref
    try:
        yield
    finally:
        pr.place_round = saved


def check_place_round(K=64, horizon=20, tail=150):
    """place_round against the plain loop on the card at K = 64, H = 100:
    one admit round of 64 candidates from a burst's fifth tick bit for bit
    in chosen, used, slot counts and pointer, both timed; then a
    horizon-``horizon`` burst episode with the kernel (one launch a tick)
    and with the plain loop, final states bit-identical; then a
    horizon-``tail`` burst telescoped with the kernel (one launch a full
    tick) against the plain loop per tick.  Returns the kernels row."""
    cfg, spec, sim0, policy = burst_100(5)
    H, N = spec.n_hosts, spec.n_nodes
    with plain_admit_loop():
        mid, _ = engine.phase_arrive(run_sim(sim0, cfg, policy, H, N, 5)[0])
    params = cfg.run_params(DEV)
    cand, valid, req_k, pcarry = engine._admit_candidates(mid, cfg, policy)
    n_valid = int(valid.sum())
    if n_valid != K:
        raise AssertionError(f"place_round: {n_valid} candidates, want {K}")
    args = (mid, cfg, params, policy, cand, valid, req_k, pcarry, n_valid)
    got, want = place_round(*args), place_round_ref(*args)
    as_bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t
    bad = [k for k in ("chosen", "used", "ncont")
           if not torch.equal(as_bits(getattr(got, k)),
                              as_bits(getattr(want, k)))]
    if bad or not torch.equal(got.carry.rr, want.carry.rr):
        raise AssertionError(f"place_round: differs from the plain loop in "
                             f"{bad or ['rr']}")
    admitted = int((got.chosen >= 0).sum())
    ms = time_ms(lambda: place_round(*args))
    plain = time_ms(lambda: place_round_ref(*args))
    # bytes: the comm costs, the two count rows and the hosts' tables read
    # once, the outputs written once
    nbytes = 4 * (H * H + 2 * K * H + 9 * H + 3 * H + 5 * K
                  + 4 * H + 2 * K)
    b = nbytes / HBM_BW * 1e3
    log(f"place_round K={K}, H={H} ({n_valid} candidates, {admitted} "
        f"admitted): bit-exact against the plain loop; kernel {ms:.4f} ms, "
        f"plain loop {plain:.4f} ms, bound {b:.6f} ms (bytes: {nbytes}; "
        f"the {n_valid} argmins depend on one another)")
    c = dataclasses.replace(cfg, horizon=horizon)
    finals, launches = {}, {}
    for name in ("kernel", "plain"):
        reset_launch_counts()
        with (plain_admit_loop() if name == "plain"
              else contextlib.nullcontext()):
            finals[name] = run_sim(sim0, c, policy, H, N, horizon)[0]
        torch.cuda.synchronize()
        launches[name] = LAUNCHES["place_round"]
    if launches != {"kernel": horizon, "plain": 0}:
        raise AssertionError(f"burst episode: place_round launches "
                             f"{launches}, want {horizon} and 0")
    bad = differing_leaves(finals["kernel"], finals["plain"])
    if bad:
        raise AssertionError(f"burst episode with place_round differs from "
                             f"the plain loop's in {bad}")
    log(f"place_round burst episode at {H} hosts, horizon {horizon}: "
        f"{launches['kernel']} launches, final state bit-identical to the "
        f"plain loop's")
    c = dataclasses.replace(cfg, horizon=tail)
    n_fw = len(range(0, tail, cfg.delay_update_interval))
    with plain_admit_loop():
        per_tick = run_sim(sim0, c, policy, H, N, tail)[0]
    (tele, _), wall, n_full, _ = telescoped_run(
        lambda: run_sim(sim0, c, policy, H, N, tail,
                        plan=ExecPlan(telescope=True)),
        tail, n_fw, "telescoped 100-host burst")
    bad = differing_leaves(per_tick, tele)
    if bad or n_full >= tail:
        raise AssertionError(f"telescoped burst with place_round: differs "
                             f"from the plain loop per tick in {bad}, "
                             f"{n_full} full ticks of {tail}")
    log(f"place_round telescoped burst at {H} hosts, horizon {tail}: "
        f"{n_full} full ticks, {n_full} launches, final state bit-identical "
        f"to the plain loop's per tick")
    return dict(
        name="place_round", route="cuda",
        source="src/repro_torch/kernels/csrc/place_round.cu",
        replaces="none: src/repro/core/engine.py:_place_batched (lax.scan)",
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b, bound_by="bytes",
        library_ms=None, launches=launches["kernel"])


def check_kernels(real_net, n_hosts):
    rows = {"seg_waterfill": check_waterfill(real_net, n_hosts)}
    rows["seg_waterfill"]["six_links"] = check_waterfill_six_links()
    _, paper_net = build_paper_network(SimConfig(), device=DEV)
    check_segment_sums(paper_net, real_net.link_bw_kbps.shape[0])
    rows["fw_minplus"] = check_fw()
    rows["place_round"] = check_place_round()
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


D256 = "paligemma-3b B=4 S=2048 Hq=8 Hkv=1 D=256 bf16"


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
             torch.bfloat16),
            (D256, (4, 2048, 8, 1, 256), torch.bfloat16)):
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
        if len(main) < 2 or name == D256:   # timed: zamba2, qwen2.5, D 256
            main[name] = (shape, (q, k, v))
    for i, (name, (shape, (q, k, v))) in enumerate(main.items()):
        ms = time_ms(lambda: flash_attention(q, k, v))
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        with reference_mode():
            plain = time_ms(lambda: flash_attention_ref(q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                       enable_gqa=True))
        b, by = bound_ms(*flash_work(*shape, elem=2), peak_ops=PEAK_FLOPS)
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
    names FlashAttentionFn and SSDScanFn look up at each call), with
    ``flash`` in place of flash_attention: phase 7's reference run and its
    control."""
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
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
# Phases 6a and 7a: the moe family, MLA and the patch/frame frontends
# ---------------------------------------------------------------------------
# arch, impl, batch, depth (None: as published), flash_attention launches
# per prefill; deepseek-v2-236b's 60 layers (236 B parameters) do not fit
# one card: its depth is cut to the leading dense layer and 2 moe layers
# at the published widths, and MLA has no kernel (impl 'ref')
FAMILIES = (("olmoe-1b-7b", "kernel", 4, None, 16),
            ("paligemma-3b", "kernel", 4, None, 18),
            ("musicgen-large", "kernel", 4, None, 48),
            ("deepseek-v2-236b", "ref", 2, 3, 0))


def family_cfg(cfg, impl, n_layers=None):
    cfg = dataclasses.replace(cfg, attn_impl=impl, ssm_impl=impl)
    return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg


def teacher_forced(cfg, params, batch, ref):
    """The prefill, then one decode step per token of ``ref`` (a ``serve``
    result) fed the tokens ``ref`` fed: the logits in ``serve``'s form."""
    n = ref["tokens"].shape[1]
    _, logits, cache, seq_len = start(cfg, params, batch, n)
    dev = logits.device
    feed = torch.cat([ref["logits"].argmax(-1)[:, None],
                      ref["tokens"][:, :-1].long()], dim=1).to(dev)
    decode = make_decode_step(cfg)
    steps = []
    for t in range(n):
        _, lg, cache = decode(params, feed[:, t:t + 1], cache, seq_len + t)
        steps.append(lg)
    return {"tokens": ref["tokens"].to(dev), "logits": logits,
            "step_logits": torch.stack(steps, dim=1)}


def reduced_families():
    """Phase 6a: the four families' reduced configs on the card against the
    port's CPU run from the same weights and prompts.  The card's own
    greedy run (``serve``) counts its launches; the comparison is teacher
    forced: the card fed the CPU run's tokens, its routing held to the CPU
    run's (``moe.log_routing``: a differing choice must be a near tie of
    the router logits), logits within MODEL_ULPS ulps and tokens equal
    wherever the CPU's margin is clear."""
    B, S, n = 4, 64, 8
    for arch, impl, _, _, _ in FAMILIES:
        cfg = family_cfg(get_reduced(arch), impl)
        params = transformer.init_params(cfg, seed=0, device="cpu")
        with moe_mod.log_routing() as routes:
            cpu = serve(cfg, params, prompt_batch(cfg, B, S, 0, "cpu"), n)
        gparams = transformer.map_leaves(lambda a: a.to(DEV), params)
        gbatch = prompt_batch(cfg, B, S, 0, DEV)
        gpu = serve(cfg, gparams, gbatch, n)
        want = cfg.n_layers if impl == "kernel" else 0
        if gpu["prefill_launches"] != {"seg_waterfill": 0, "fw_minplus": 0,
                                       "flash_attention": want,
                                       "ssd_scan": 0, "place_round": 0} \
                or any(gpu["decode_launches"].values()):
            raise AssertionError(f"reduced {arch} launches: prefill "
                                 f"{gpu['prefill_launches']}, decode "
                                 f"{gpu['decode_launches']}")
        with moe_mod.log_routing(replay=routes.topi) as rep:
            forced = teacher_forced(cfg, gparams, gbatch, cpu)
        gap, compared = compare_greedy(cpu, forced, MODEL_ULPS)
        log(f"reduced {arch} ({impl}) serve B={B} S={S} gen={n}: card "
            f"equals the CPU run, teacher forced ({compared} of {B * n} "
            f"tokens compared, logits at most {gap:.2f} bf16 ulps apart, "
            f"{sum(rep.replaced)} of {sum(a for a, _ in routes.drops)} "
            f"top-k positions replayed at a near tie), launches "
            f"{gpu['prefill_launches']}")


def family_serve(arch, impl, B, n_layers, want_flash, S=2048, n=32):
    """Phase 7a, one model at full width (see FAMILIES), through ``serve``:
    launch counts reset just before and read just after (``want_flash``
    flash_attention in the prefill, none in decode), logits finite, the
    same prefill through the plain versions (routing held to the kernel
    run's) within FULL_ULPS, a second run bit-identical.  Returns the
    launches of the first run."""
    cfg = family_cfg(get_config(arch), impl, n_layers)
    t0 = time.time()
    params = transformer.init_params(cfg, seed=0, device=DEV)
    batch = prompt_batch(cfg, B, S, 0, DEV)
    torch.cuda.synchronize()
    leaves = []
    transformer.map_leaves(leaves.append, params)
    weights = sum(a.numel() * a.element_size() for a in leaves)
    del leaves
    log(f"{arch} ({cfg.n_layers} layers): weights {weights / 2**30:.3f} "
        f"GiB, drawn in {time.time() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    with moe_mod.log_routing() as routes:
        out = serve(cfg, params, batch, n)      # counts reset inside
    peak = torch.cuda.max_memory_allocated()
    pf, dec = out["prefill_launches"], out["decode_launches"]
    if pf != {"seg_waterfill": 0, "fw_minplus": 0,
              "flash_attention": want_flash, "ssd_scan": 0,
              "place_round": 0} \
            or any(dec.values()):
        raise AssertionError(f"{arch} launches: prefill {pf}, decode {dec}")
    toks = out["tokens"]
    if toks.shape != (B, n) or not bool(((toks >= 0)
                                         & (toks < cfg.vocab_padded)).all()):
        raise AssertionError(f"{arch} tokens {toks.shape}")
    for k in ("logits", "step_logits"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{arch} {k} not finite")
    n_moe = n_moe_layers(cfg)
    drops = ""
    if n_moe:
        share = moe_mod.dropped_share
        drops = (f", dropped at capacity C = "
                 f"{moe_mod.capacity(B * S, cfg)}: "
                 f"{share(routes.drops[:n_moe]):.6f} of the prefill's "
                 f"assignments, {share(routes.drops[n_moe:]):.6f} of "
                 f"decode's")
    flops = prefill_flops(cfg, B, S)
    log(f"{arch} serve B={B} prompt={S} gen={n}: prefill "
        f"{out['prefill_ms']:.3f} ms ({flops:.4e} FLOP, "
        f"{flops / out['prefill_ms'] / 1e9:.1f} TFLOP/s), decode "
        f"{out['decode_tok_s']:.2f} tok/s, peak device memory "
        f"{peak / 2**30:.3f} GiB{drops}, launches prefill {pf} decode {dec}")

    # the same prefill through the plain versions, routed as the kernels'
    # run: over a full-width stack the two runs' router logits drift apart
    # as their final logits may, so a near tie is held to FULL_ULPS too
    with plain_versions(), reference_mode(), \
            moe_mod.log_routing(replay=routes.topi[:n_moe],
                                tie_ulps=FULL_ULPS) as rep:
        reset_launch_counts()
        ref_logits, _, _ = transformer.prefill(cfg, params, batch)
        torch.cuda.synchronize()
        plain_counts = dict(LAUNCHES)
    if any(plain_counts.values()):
        raise AssertionError(f"plain-version prefill launched {plain_counts}")
    gap = ulp_gap(out["logits"], ref_logits)
    if gap > FULL_ULPS:
        raise AssertionError(f"{arch} prefill logits {gap:.2f} bf16 ulps "
                             f"from the plain versions' (> {FULL_ULPS})")
    log(f"{arch} prefill through the plain versions: logits {gap:.2f} bf16 "
        f"ulps from the kernels' (bound {FULL_ULPS}; {sum(rep.replaced)} of "
        f"{sum(a for a, _ in rep.drops)} top-k positions replayed at a tie "
        f"within {FULL_ULPS} ulps)")
    del ref_logits

    out2 = serve(cfg, params, batch, n)
    for k in ("tokens", "logits", "step_logits"):
        if not torch.equal(out[k], out2[k]):
            raise AssertionError(f"second {arch} run's {k} differs")
    log(f"{arch} second run: bit-identical tokens and logits (prefill "
        f"{out2['prefill_ms']:.3f} ms, decode {out2['decode_tok_s']:.2f} "
        f"tok/s)")
    del params, out, out2, routes
    torch.cuda.empty_cache()
    return {k: pf[k] + dec[k] for k in pf}


def families_phase():
    counts = {}
    for arch, impl, B, n_layers, want_flash in FAMILIES:
        got = family_serve(arch, impl, B, n_layers, want_flash)
        counts = {k: counts.get(k, 0) + v for k, v in got.items()}
    return counts


# ---------------------------------------------------------------------------
# Phase 9: training on one card
# ---------------------------------------------------------------------------
TRAIN_RTOL = 1e-3    # a loss, card against CPU and kernels against 'ref'
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def equal_trees(a, b) -> bool:
    la, lb = topt.tree_leaves(a), topt.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def grads_of(fn, inputs, cotangent):
    """(outputs, gradients) of ``fn`` at fresh leaf copies of ``inputs``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    first = out[0] if isinstance(out, tuple) else out
    return out, torch.autograd.grad(first, leaves, cotangent)


def check_train_functions():
    """Phase 9 (i): FlashAttentionFn and SSDScanFn at the zamba2-1.2b
    shapes: forward equal to the raw kernel's, gradients equal to the plain
    version's autograd on the card, bit for bit (the same recompute); a raw
    wrapper given an input that requires grad raises.  Times the forward
    and the backward (the plain recompute and its VJP) apart."""
    q, k, v = flash_inputs(4, 2048, 32, 32, 64, torch.bfloat16, seed=30)
    g = flash_inputs(4, 2048, 32, 32, 64, torch.bfloat16, seed=31)[0]
    ins = ssd_inputs(4, 2048, 64, 64, 64, seed=32)
    gy = ssd_inputs(4, 2048, 64, 64, 64, seed=33)[0]
    cases = (("flash_attention", lambda *a: FlashAttentionFn.apply(*a, True,
                                                                   None),
              flash_attention_ref, flash_attention, (q, k, v), g),
             ("ssd_scan", lambda *a: SSDScanFn.apply(*a, 256),
              lambda *a: ssd_chunked_ref(*a, 256), ssd_scan, ins, gy))
    for name, fn, plain, raw, inputs, cot in cases:
        out, got = grads_of(fn, inputs, cot)
        with torch.no_grad():
            want_out = raw(*inputs)
        outs = out if isinstance(out, tuple) else (out,)
        wants = want_out if isinstance(want_out, tuple) else (want_out,)
        if not all(torch.equal(a, b) for a, b in zip(outs, wants)):
            raise AssertionError(f"{name}: the Function's forward differs "
                                 f"from the raw kernel's")
        _, want = grads_of(plain, inputs, cot)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: the Function's gradients differ "
                                 f"from the plain version's autograd")
        try:
            raw(inputs[0].detach().clone().requires_grad_(True),
                *inputs[1:])
        except RuntimeError as e:
            if "requires grad" not in str(e):
                raise
        else:
            raise AssertionError(f"{name}: the raw wrapper took an input "
                                 f"that requires grad")
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]

        def fwd_bwd():
            out = fn(*leaves)
            torch.autograd.grad(out[0] if isinstance(out, tuple) else out,
                                leaves, cot)
        fwd = time_ms(lambda: fn(*inputs), runs=1)
        both = time_ms(fwd_bwd, runs=1)
        log(f"{name} autograd Function at the zamba2-1.2b shape: forward "
            f"equal to the raw kernel's, {len(got)} gradients equal to the "
            f"plain version's autograd bit for bit, the raw wrapper refuses "
            f"an input that requires grad; forward {fwd:.3f} ms, forward + "
            f"backward {both:.3f} ms (the backward, the plain recompute, "
            f"{both - fwd:.3f} ms)")
        del out, got, want


def reduced_training():
    """Phase 9 (ii): reduced smollm-360m and zamba2-1.2b, 3 steps on the
    card (kernels) and on the CPU (plain versions) from one state and the
    same batches: each step's loss within TRAIN_RTOL."""
    for arch in ("smollm-360m", "zamba2-1.2b"):
        cfg = kernel_cfg(get_reduced(arch))
        cpu = init_train_state(cfg, seed=0, device="cpu")
        gpu = topt.tree_map(lambda t: t.to(DEV), cpu)
        step = make_train_step(cfg, topt.OptimizerConfig(**TRAIN_OPT))
        data = SyntheticLM(DataConfig(seq_len=64, global_batch=4,
                                      vocab=cfg.vocab, seed=0))
        rows = []
        for i in range(3):
            batch = data.batch_at(i)
            cpu, mc = step(cpu, to_device(batch, "cpu"))
            gpu, mg = step(gpu, to_device(batch, DEV))
            lc, lg = float(mc["loss"]), float(mg["loss"])
            if not abs(lg - lc) <= TRAIN_RTOL * abs(lc):
                raise AssertionError(f"reduced {arch} step {i}: loss {lg} on "
                                     f"the card, {lc} on the CPU")
            rows.append(f"{lg:.6f}/{lc:.6f}")
        log(f"reduced {arch} training, 3 steps B=4 S=64, card (kernels) / "
            f"CPU (plain versions) losses {', '.join(rows)}: within rtol "
            f"{TRAIN_RTOL}")


def resume_check():
    """Phase 9 (iii): launch.train on reduced zamba2 with a checkpoint
    every 2 steps; its step_4 removed, a rerun restores step_2 and runs
    steps 3-4: final state bit-identical to the uninterrupted run's."""
    with tempfile.TemporaryDirectory() as d:
        argv = ["--reduced", "--arch", "zamba2-1.2b", "--steps", "4",
                "--batch", "4", "--seq", "64", "--log-every", "1",
                "--ckpt-dir", d, "--ckpt-every", "2"]
        full = train_cli.main(argv)
        step4 = os.path.join(d, "step_4")
        for f in os.listdir(step4):
            os.remove(os.path.join(step4, f))
        os.rmdir(step4)
        resumed = train_cli.main(argv)
    if resumed["start_step"] != 2 or not equal_trees(full["state"],
                                                     resumed["state"]):
        raise AssertionError("resumed reduced zamba2 differs from the "
                             "uninterrupted run")
    if resumed["losses"] != full["losses"][2:]:
        raise AssertionError("resumed losses differ")
    log(f"reduced zamba2 checkpoint at step 2, restored, steps 3-4: final "
        f"state bit-identical to the uninterrupted 4 steps (losses "
        f"{', '.join(f'{x:.6f}' for x in full['losses'])})")


def train_steps(cfg, batches):
    """init_train_state(seed=0), then one train step a batch, each timed
    on the host clock to its end: (final state, [(loss, grad norm, ms,
    launches)], peak device memory, the memory held before the state was
    drawn)."""
    step = make_train_step(cfg, topt.OptimizerConfig(total_steps=4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = init_train_state(cfg, seed=0, device=DEV)
    rows = []
    reset_launch_counts()
    for b in batches:
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append((loss, gn, ms, {k: LAUNCHES[k] - before[k]
                                    for k in ("flash_attention",
                                              "ssd_scan")}))
    return state, rows, torch.cuda.max_memory_allocated(), base


def full_width_training(B=4, S=2048, n_steps=4):
    """Phase 9 (iv): zamba2-1.2b as published, batch 4 x 2048, remat on,
    AdamW, SyntheticLM(seed 0), 4 steps from init_train_state(seed=0):
    12 flash_attention and 76 ssd_scan launches a step (forward and remat
    rerun), finite loss and grad norm, step ms (median of steps 2-4),
    tokens/s and peak memory; one step with impl 'ref' from the same
    state (loss within TRAIN_RTOL); a second run bit-identical."""
    cfg = kernel_cfg(get_config("zamba2-1.2b"))
    assert cfg.remat
    data = SyntheticLM(DataConfig(seq_len=S, global_batch=B,
                                  vocab=cfg.vocab, seed=0))
    batches = [to_device(data.batch_at(i), DEV) for i in range(n_steps)]
    n_apps = cfg.n_layers // cfg.attn_every
    want = {"flash_attention": 2 * n_apps, "ssd_scan": 2 * cfg.n_layers}
    state, rows, peak, base = train_steps(cfg, batches)
    counts = dict(LAUNCHES)
    for i, (loss, gn, ms, got) in enumerate(rows):
        if got != want:
            raise AssertionError(f"full-width step {i}: launches {got}, "
                                 f"want {want}")
        if not (np.isfinite(loss) and np.isfinite(gn)):
            raise AssertionError(f"full-width step {i}: loss {loss}, grad "
                                 f"norm {gn}")
    med = statistics.median(ms for _, _, ms, _ in rows[1:])
    log(f"zamba2-1.2b training B={B} S={S}, remat, AdamW: step ms "
        f"{', '.join(f'{r[2]:.1f}' for r in rows)} (median of steps 2-"
        f"{n_steps} {med:.1f} ms, {B * S / med * 1e3:.1f} tokens/s), peak "
        f"device memory {peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB held "
        f"before the state was drawn), losses "
        f"{', '.join(f'{r[0]:.6f}' for r in rows)}, grad norms "
        f"{', '.join(f'{r[1]:.6f}' for r in rows)}; launches a step {want}")
    params = state.params
    del state

    ref_cfg = dataclasses.replace(cfg, attn_impl="ref", ssm_impl="ref")
    ref_state, ref_rows, ref_peak, _ = train_steps(ref_cfg, batches[:1])
    del ref_state
    (rl, rg, rms, rgot), l0 = ref_rows[0], rows[0][0]
    if any(rgot.values()) or not abs(rl - l0) <= TRAIN_RTOL * abs(l0):
        raise AssertionError(f"full-width impl 'ref' step: loss {rl} against "
                             f"{l0}, launches {rgot}")
    log(f"zamba2-1.2b one step with impl 'ref' from the same state: loss "
        f"{rl:.6f} against the kernels' {l0:.6f} (rtol {TRAIN_RTOL}), grad "
        f"norm {rg:.6f} against {rows[0][1]:.6f}, {rms:.1f} ms, peak "
        f"{ref_peak / 2**30:.3f} GiB")

    state2, rows2, _, _ = train_steps(cfg, batches)
    if [r[:2] for r in rows2] != [r[:2] for r in rows] or \
            not equal_trees(state2.params, params):
        raise AssertionError("second full-width training run differs")
    log(f"zamba2-1.2b second training run: losses, grad norms and final "
        f"parameters bit-identical (step ms "
        f"{', '.join(f'{r[2]:.1f}' for r in rows2)})")
    return counts


def train_phase():
    t0 = time.time()
    check_train_functions()
    reduced_training()
    resume_check()
    counts = full_width_training()
    log(f"phase 9 wall time {time.time() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 10: training the moe family and MLA; the mesh path
# ---------------------------------------------------------------------------
# a later step's routing, card against CPU: after AdamW's first update
# (about +-lr an element) the two runs' parameters differ where a gradient
# element is near zero, and router logits move by more than a near tie of
# summation order (tests/test_torch_train_moe.py measures 11.4 ulps)
STEP_TIE_ULPS = 16
GRAD_ULPS = 8        # a gradient leaf, card against CPU (bf16 ulps of max)
MESH_WORKERS = 2


def moe_train_run(cfg, batches, device, routes=None):
    """3 AdamW steps from init_train_state(seed=0) (drawn on the CPU) on
    ``device``: (final params, losses, each step's routing, replayed
    positions a step, flash_attention launches a step).  With ``routes``
    each step's routing is held to that run's (the first at
    moe.NEAR_TIE_ULPS, the later ones at STEP_TIE_ULPS)."""
    state = topt.tree_map(lambda t: t.to(device),
                          init_train_state(cfg, seed=0, device="cpu"))
    step = make_train_step(cfg, topt.OptimizerConfig(**TRAIN_OPT))
    losses, got, replaced, launches = [], [], [], []
    for i, b in enumerate(batches):
        before = LAUNCHES["flash_attention"]
        with moe_mod.log_routing(
                replay=None if routes is None else routes[i],
                tie_ulps=moe_mod.NEAR_TIE_ULPS if i == 0
                else STEP_TIE_ULPS) as log:
            state, m = step(state, to_device(b, device))
        losses.append(float(m["loss"]))
        got.append(log.topi)
        replaced.append(sum(log.replaced))
        launches.append(LAUNCHES["flash_attention"] - before)
    return state.params, losses, got, replaced, launches


def reduced_moe_training():
    """Phase 10 (i): reduced olmoe-1b-7b (kernels) and deepseek-v2 (MLA:
    impl 'ref'), batch 4 x 64, 3 steps on the card against the port's CPU
    run from one state, the card's routing held to the CPU run's: each
    loss within TRAIN_RTOL; a second card run bit-identical."""
    for arch, impl in (("olmoe-1b-7b", "kernel"), ("deepseek-v2-236b",
                                                   "ref")):
        cfg = family_cfg(get_reduced(arch), impl)
        data = SyntheticLM(DataConfig(seq_len=64, global_batch=4,
                                      vocab=cfg.vocab, seed=0))
        batches = [data.batch_at(i) for i in range(3)]
        _, want, routes, _, _ = moe_train_run(cfg, batches, "cpu")
        first = moe_train_run(cfg, batches, DEV, routes)
        params, losses, _, replaced, launches = first
        flash = 2 * cfg.n_layers if impl == "kernel" else 0
        if launches != [flash] * 3:
            raise AssertionError(f"reduced {arch} training launches "
                                 f"{launches}, want {flash} a step")
        for i, (g, c) in enumerate(zip(losses, want)):
            if not abs(g - c) <= TRAIN_RTOL * abs(c):
                raise AssertionError(f"reduced {arch} step {i}: loss {g} on "
                                     f"the card, {c} on the CPU")
        params2, losses2, _, _, _ = moe_train_run(cfg, batches, DEV, routes)
        if losses2 != losses or not equal_trees(params, params2):
            raise AssertionError(f"second reduced {arch} training run "
                                 f"differs")
        log(f"reduced {arch} ({impl}) training, 3 steps B=4 S=64, card / "
            f"CPU losses "
            f"{', '.join(f'{a:.6f}/{b:.6f}' for a, b in zip(losses, want))}"
            f": within rtol {TRAIN_RTOL}; top-k positions replayed a step "
            f"{replaced}; flash_attention launches a step {launches}; a "
            f"second card run bit-identical")


def full_width_moe_training(B=4, S=2048, n_layers=4, n_steps=4):
    """Phase 10 (ii): olmoe-1b-7b at its published widths cut to
    ``n_layers`` of 16 layers, batch 4 x 2048, remat, AdamW on f32
    masters, SyntheticLM(seed 0), 4 steps from init_train_state(seed=0):
    2 flash_attention launches a layer a step (forward and remat rerun),
    finite losses, step ms (median of steps 2-4), tokens/s, peak memory,
    the share of assignments dropped at capacity; a second run
    bit-identical (its parameters held on the host meanwhile)."""
    cfg = kernel_cfg(dataclasses.replace(get_config("olmoe-1b-7b"),
                                         n_layers=n_layers))
    assert cfg.remat
    data = SyntheticLM(DataConfig(seq_len=S, global_batch=B,
                                  vocab=cfg.vocab, seed=0))
    batches = [to_device(data.batch_at(i), DEV) for i in range(n_steps)]
    want = {"flash_attention": 2 * n_layers, "ssd_scan": 0}
    with moe_mod.log_routing() as routes:
        state, rows, peak, base = train_steps(cfg, batches)
    counts = dict(LAUNCHES)
    for i, (loss, gn, ms, got) in enumerate(rows):
        if got != want or not (np.isfinite(loss) and np.isfinite(gn)):
            raise AssertionError(f"olmoe-1b-7b step {i}: launches {got} "
                                 f"(want {want}), loss {loss}, grad norm "
                                 f"{gn}")
    med = statistics.median(ms for _, _, ms, _ in rows[1:])
    n_params = sum(t.numel() for t in topt.tree_leaves(state.params))
    share = moe_mod.dropped_share(routes.drops)
    log(f"olmoe-1b-7b training ({n_layers} of 16 layers, {n_params:.4e} "
        f"parameters) B={B} S={S}, remat, AdamW: step ms "
        f"{', '.join(f'{r[2]:.1f}' for r in rows)} (median of steps 2-"
        f"{n_steps} {med:.1f} ms, {B * S / med * 1e3:.1f} tokens/s), peak "
        f"device memory {peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB held "
        f"before the state was drawn), dropped at capacity C = "
        f"{moe_mod.capacity(B * S, cfg)}: {share:.6f} of "
        f"{sum(int(a) for a, _ in routes.drops)} assignments over "
        f"{len(routes.drops)} moe calls, losses "
        f"{', '.join(f'{r[0]:.6f}' for r in rows)}, grad norms "
        f"{', '.join(f'{r[1]:.6f}' for r in rows)}; launches a step {want}")
    params = topt.tree_map(lambda t: t.cpu(), state.params)
    del state
    torch.cuda.empty_cache()
    state2, rows2, _, _ = train_steps(cfg, batches)
    same = [r[:2] for r in rows2] == [r[:2] for r in rows] and all(
        torch.equal(a.cpu(), b) for a, b in zip(
            topt.tree_leaves(state2.params), topt.tree_leaves(params)))
    if not same:
        raise AssertionError("second olmoe-1b-7b training run differs")
    log(f"olmoe-1b-7b second training run: losses, grad norms and final "
        f"parameters bit-identical (step ms "
        f"{', '.join(f'{r[2]:.1f}' for r in rows2)})")
    del state2, params
    torch.cuda.empty_cache()
    return counts


def mesh_worker(argv):
    """One rank of phase 10 (iii) (``chip_smoke.py --mesh-worker RANK PORT
    OUT``): reduced olmoe (kernels) on the (1, 2) mesh, ``moe_impl``
    'psum' then 'a2a', over a gloo group of MESH_WORKERS ranks that share
    the card: the gradient and 2 steps run once with the state on the
    CPU and once on the card (the card's routing held to the CPU's), the
    collectives staging the card's tensors through host memory.  Rank 0
    writes the comparison to OUT."""
    import datetime
    import torch.distributed as tdist
    from repro_torch.launch.mesh import compat_mesh
    from repro_torch.models import sharding as shd
    from repro_torch.train import step as tstep
    rank, port, out = int(argv[0]), int(argv[1]), argv[2]
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=MESH_WORKERS, rank=rank,
                             timeout=datetime.timedelta(seconds=300))
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.cuda.set_device(0)          # every rank shares the one card
    mesh = compat_mesh((1, MESH_WORKERS), ("data", "model"), "cuda")
    res = {}
    for impl in ("psum", "a2a"):
        cfg = dataclasses.replace(kernel_cfg(get_reduced("olmoe-1b-7b")),
                                  moe_impl=impl)
        specs = tstep.state_specs(cfg, mesh).params
        data = SyntheticLM(DataConfig(seq_len=64, global_batch=4,
                                      vocab=cfg.vocab, seed=0))
        batches = [data.batch_at(i) for i in range(2)]
        grad_fn = tstep.make_grad_fn(cfg, tstep.StepConfig(), mesh)
        step = tstep.make_train_step(cfg, topt.OptimizerConfig(**TRAIN_OPT),
                                     mesh=mesh)
        runs = {}
        for dev in ("cpu", DEV):
            state = topt.tree_map(lambda t: t.to(dev), tstep.init_train_state(
                cfg, seed=0, device="cpu", mesh=mesh))
            routes = runs["cpu"]["routes"] if dev == DEV else [None] * 3
            reset_launch_counts()
            with moe_mod.log_routing(replay=routes[0]) as lg:
                loss, _, grads, norm = grad_fn(state.params,
                                               to_device(batches[0], dev))
            grads = shd.map_specs(
                lambda spec, g: shd.gather(g, spec, mesh,
                                           differentiable=False).cpu(),
                specs, grads)
            losses, step_routes = [], [lg.topi]
            for i, b in enumerate(batches):
                with moe_mod.log_routing(
                        replay=routes[i + 1],
                        tie_ulps=moe_mod.NEAR_TIE_ULPS if i == 0
                        else STEP_TIE_ULPS) as lg:
                    state, m = step(state, to_device(b, dev))
                losses.append(float(m["loss"]))
                step_routes.append(lg.topi)
            runs[dev if dev == "cpu" else "cuda"] = {
                "loss": float(loss), "norm": float(norm), "losses": losses,
                "grads": topt.tree_leaves(grads), "routes": step_routes,
                "flash": LAUNCHES["flash_attention"]}
        cpu, gpu = runs["cpu"], runs["cuda"]
        ulps = max(float((a - b).abs().max()
                         / (2.0 ** -8 * b.abs().max().clamp_min(1e-30)))
                   for a, b in zip(gpu["grads"], cpu["grads"]))
        cos = min(float((a.double() * b.double()).sum()
                        / (a.double().norm() * b.double().norm())
                        .clamp_min(1e-300))
                  for a, b in zip(gpu["grads"], cpu["grads"])
                  if b.abs().max() > 0)
        res[impl] = {k: (v if k not in ("grads", "routes") else None)
                     for k, v in gpu.items()}
        res[impl].update(cpu_loss=cpu["loss"], cpu_losses=cpu["losses"],
                         grad_ulps=ulps, grad_cos=cos)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    tdist.barrier()
    tdist.destroy_process_group()


def mesh_path():
    """Phase 10 (iii): MESH_WORKERS processes sharing the card over gloo
    (NCCL refuses two ranks on one device), reduced olmoe on the (1, 2)
    mesh with moe_impl 'psum' and 'a2a' (``_ep_shard`` and
    ``_ep_a2a_shard`` at two model shards): the card's loss and gradient
    against the port's CPU run at the same mesh (loss rtol TRAIN_RTOL,
    every gradient leaf within GRAD_ULPS bf16 ulps of its largest
    magnitude, cosine >= 0.999), 2 steps' losses rtol TRAIN_RTOL; no speed
    across cards is stated (one card)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.time()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "mesh.json")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--mesh-worker", str(r), str(port), out],
                                  env=env)
                 for r in range(MESH_WORKERS)]
        try:
            for p in procs:
                p.wait(timeout=300)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise AssertionError(f"mesh workers exited with "
                                 f"{[p.returncode for p in procs]}")
        with open(out) as f:
            res = json.load(f)
    for impl, r in res.items():
        pairs = [(r["loss"], r["cpu_loss"])] + list(zip(r["losses"],
                                                        r["cpu_losses"]))
        if any(not abs(a - b) <= TRAIN_RTOL * abs(b) for a, b in pairs) \
                or r["grad_ulps"] > GRAD_ULPS or r["grad_cos"] < 0.999 \
                or r["flash"] == 0:
            raise AssertionError(f"mesh path {impl}: {r}")
        log(f"mesh (1, {MESH_WORKERS}) reduced olmoe moe_impl {impl!r}, "
            f"{MESH_WORKERS} gloo ranks on one card (every collective "
            f"staged through host memory): loss {r['loss']:.6f} / CPU "
            f"{r['cpu_loss']:.6f}, gradient within {r['grad_ulps']:.2f} "
            f"bf16 ulps of max (cosine >= {r['grad_cos']:.6f}), steps "
            f"{', '.join(f'{a:.6f}/{b:.6f}' for a, b in pairs[1:])}; "
            f"flash_attention launches on rank 0 {r['flash']}")
    log(f"phase 10 (iii) wall time {time.time() - t0:.1f} s (worker start-up "
        f"included)")


def moe_training_phase():
    t0 = time.time()
    reduced_moe_training()
    counts = full_width_moe_training()
    mesh_path()
    log(f"phase 10 wall time {time.time() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 11: serving on a mesh; the dry run against the card
# ---------------------------------------------------------------------------
SERVE_WORKERS = 2
SERVE_STEPS = 8
# phase 11 (ii): the card's peak memory of a step over the cost counter's
# argument + temp bytes for it must lie in this band (PERF.md §6)
MEMORY_RATIO = (0.8, 1.25)
# phase 11 (iii): the meshes of the full dry run: "single" (40 cells), as
# "both" (80) took 208.0 s on the card's host, over the 3 minutes allowed
DRYRUN_MESH = "single"
DRY_CELLS = (("zamba2-1.2b", None, "prefill"), ("zamba2-1.2b", None, "train"),
             ("olmoe-1b-7b", 4, "train"))
DRY_B, DRY_S = 4, 2048


def mesh_serve(cfg, params, batch, n, mesh, dp, feed=None, routes=None):
    """The prefill and ``n`` decode steps on ``mesh`` (greedy, or fed the
    global tokens ``feed`` [B, n], the routing held to ``routes``): the
    rank's rows of the prefill and step logits, the global tokens fed,
    the routing and the launches of the prefill and of the decode."""
    replay = (lambda i: None) if routes is None else (lambda i: routes[i])
    reset_launch_counts()
    with moe_mod.log_routing(replay=replay(0)) as lg:
        tok, logits, cache, S = start(cfg, params, batch, n, None, mesh, dp)
    pf_launch, got = dict(LAUNCHES), [lg.topi]
    reset_launch_counts()
    decode = make_decode_step(cfg, mesh, dp)
    fed, steps = [all_rows(tok, cache)], []
    for t in range(n):
        x = fed[-1] if feed is None else feed[:, t]
        with moe_mod.log_routing(replay=replay(t + 1)) as lg:
            tok, lg_t, cache = decode(params, x[:, None], cache, S + t)
        got.append(lg.topi)
        steps.append(lg_t)
        fed.append(all_rows(tok, cache) if feed is None else None)
    fed = torch.stack(fed[:-1], 1) if feed is None else feed
    return {"logits": logits, "steps": torch.stack(steps, 1), "feed": fed,
            "routes": got, "prefill": pf_launch, "decode": dict(LAUNCHES)}


def serve_worker(argv):
    """One rank of phase 11 (i) (``chip_smoke.py --serve-worker RANK PORT
    OUT``): reduced olmoe-1b-7b and zamba2-1.2b (kernels) served on the
    (1, SERVE_WORKERS) mesh over a gloo group of ranks sharing the card,
    once with the weights and the batch on the CPU (greedy) and once on
    the card (fed the CPU's tokens, routed as the CPU run was); this
    rank's rows compared, written to OUT.rankR."""
    import datetime
    import torch.distributed as tdist
    from repro_torch.launch.mesh import compat_mesh
    from repro_torch.models import sharding as shd
    rank, port, out = int(argv[0]), int(argv[1]), argv[2]
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=SERVE_WORKERS, rank=rank,
                             timeout=datetime.timedelta(seconds=300))
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.cuda.set_device(0)          # every rank shares the one card
    mesh = compat_mesh((1, SERVE_WORKERS), ("data", "model"), "cuda")
    dp = shd.data_axes(mesh)
    res = {}
    for arch in ("olmoe-1b-7b", "zamba2-1.2b"):
        cfg = kernel_cfg(get_reduced(arch))
        params = serve_init_params(cfg, 0, "cpu", mesh)
        batch = prompt_batch(cfg, 4, 64, 0, "cpu")
        cpu = mesh_serve(cfg, params, batch, SERVE_STEPS, mesh, dp)
        gpu = mesh_serve(cfg, topt.tree_map(lambda t: t.to(DEV), params),
                         to_device(batch, DEV), SERVE_STEPS, mesh, dp,
                         feed=cpu["feed"].to(DEV), routes=cpu["routes"])
        row = {}
        for k in ("logits", "steps"):
            ref, got = cpu[k], gpu[k].cpu()
            tol = MODEL_ULPS * ulp_bf16(float(ref.abs().max()))
            part = ref.sort(-1).values
            clear = (part[..., -1] - part[..., -2]) > 2 * tol
            toks = got.argmax(-1) == ref.argmax(-1)
            row[k] = {"ulps": ulp_gap(got, ref),
                      "tokens_equal": bool(toks[clear].all()),
                      "clear": int(clear.sum()), "n": clear.numel()}
        row["launches"] = {"prefill": gpu["prefill"],
                           "decode": gpu["decode"]}
        res[arch] = row
    with open(f"{out}.rank{rank}", "w") as f:
        json.dump(res, f)
    tdist.barrier()
    tdist.destroy_process_group()


def serving_mesh():
    """Phase 11 (i): SERVE_WORKERS processes sharing the card over gloo,
    reduced olmoe and zamba2 with kernels on the (1, 2) mesh: prefill and
    SERVE_STEPS decode steps on the card against the CPU run at the same
    mesh, each rank's rows within MODEL_ULPS and its tokens equal where
    the CPU's top-2 margin is clear; flash_attention and ssd_scan
    launches per rank."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.time()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "serve.json")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--serve-worker", str(r), str(port), out],
                                  env=env)
                 for r in range(SERVE_WORKERS)]
        try:
            for p in procs:
                p.wait(timeout=300)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise AssertionError(f"serve workers exited with "
                                 f"{[p.returncode for p in procs]}")
        res = []
        for r in range(SERVE_WORKERS):
            with open(f"{out}.rank{r}") as f:
                res.append(json.load(f))
    for r, per in enumerate(res):
        for arch, row in per.items():
            bad = [k for k in ("logits", "steps")
                   if row[k]["ulps"] > MODEL_ULPS
                   or not row[k]["tokens_equal"]]
            lp = row["launches"]
            if bad or not lp["prefill"]["flash_attention"] or any(
                    lp["decode"].values()):
                raise AssertionError(f"mesh serving {arch} rank {r}: {row}")
            log(f"mesh (1, {SERVE_WORKERS}) serving reduced {arch} rank {r}"
                f" (kernels; card vs CPU at the same mesh, fed the CPU's "
                f"tokens, routed as it): prefill logits "
                f"{row['logits']['ulps']:.2f} and {SERVE_STEPS} decode "
                f"steps' {row['steps']['ulps']:.2f} bf16 ulps of max (bound"
                f" {MODEL_ULPS}), tokens equal where the margin is clear "
                f"({row['steps']['clear']} of {row['steps']['n']}); "
                f"launches a prefill: flash_attention "
                f"{lp['prefill']['flash_attention']}, ssd_scan "
                f"{lp['prefill']['ssd_scan']}; decode {lp['decode']}")
    log(f"phase 11 (i) wall time {time.time() - t0:.1f} s (worker start-up "
        f"included)")


def _storage_bytes(leaves) -> int:
    seen, n = set(), 0
    for t in leaves:
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            n += st.nbytes()
    return n


def card_cell(cfg, shape, mesh, dp, reps=3):
    """A dry-run cell's step run on the card at the host mesh: (median ms
    of ``reps`` synced steps after the first, the first step's peak bytes
    with its arguments over what the card held before they were drawn,
    the arguments' bytes, the bytes the card holds after the first step
    beyond that and the arguments)."""
    from repro_torch.serve.step import make_prefill_step
    from repro_torch.train.step import StepConfig
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    if shape.kind == "train":
        state = init_train_state(cfg, 0, DEV, mesh)
        data = SyntheticLM(DataConfig(seq_len=shape.seq_len,
                                      global_batch=shape.global_batch,
                                      vocab=cfg.vocab, seed=0))
        batch = to_device(data.batch_at(0), DEV)
        step = make_train_step(cfg, topt.OptimizerConfig(), StepConfig(),
                               mesh=mesh, dp=dp)
        args = [state, batch]
        run = lambda: step(args[0], args[1])[0]
        leaves = topt.tree_leaves(state.params) + topt.tree_leaves(
            state.opt.m) + topt.tree_leaves(state.opt.v) + [
            state.opt.step] + list(batch.values())
    else:
        params = serve_init_params(cfg, 0, DEV, mesh, masters=True)
        batch = prompt_batch(cfg, shape.global_batch, shape.seq_len, 0, DEV)
        step = make_prefill_step(cfg, mesh, dp)
        args = [params, batch]
        run = lambda: step(params, batch)
        leaves = topt.tree_leaves(params) + list(batch.values())
    grad = torch.enable_grad if shape.kind == "train" else torch.no_grad
    arg_bytes = _storage_bytes(leaves)
    with grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        del out
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        held = torch.cuda.memory_allocated() - base - arg_bytes
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del out
    del args, leaves, step, run
    torch.cuda.empty_cache()
    return statistics.median(times), peak, arg_bytes, held


def dryrun_against_card():
    """Phase 11 (ii): the (1, 1) shape-only dry run of cells the script
    runs at full width (zamba2-1.2b's prefill at batch 4 x 2048, its
    training step; olmoe-1b-7b cut to 4 of 16 layers, training), beside
    the same step on the card at the host mesh: the count's bound
    max(t_compute, t_memory) must not beat the measured time, and the
    card's peak bytes over the count's argument + temp must lie in
    MEMORY_RATIO."""
    import torch.distributed as tdist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ShapeMesh, make_host_mesh
    from repro_torch.models.config import ShapeSpec
    host = make_host_mesh("cuda")
    dp = ("data",)
    try:
        for arch, n_layers, kind in DRY_CELLS:
            cfg = kernel_cfg(get_config(arch))
            if n_layers:
                cfg = dataclasses.replace(cfg, n_layers=n_layers)
            shape = ShapeSpec(f"{kind}_{DRY_S}", DRY_S, DRY_B, kind)
            cc, arg_bytes, _, secs = dryrun.trace_cell(
                cfg, shape, ShapeMesh((1, 1), ("data", "model")))
            terms = cc.terms(1)
            bound = max(terms.t_compute, terms.t_memory) * 1e3
            counted = cc.peak_bytes
            ms, peak, card_args, held = card_cell(cfg, shape, host, dp)
            ratio = peak / counted
            layers = f" ({n_layers} of 16 layers)" if n_layers else ""
            log(f"dry run vs card, {arch}{layers} {kind} B={DRY_B} "
                f"S={DRY_S} at "
                f"(1, 1): counted {cc.flops:.4e} FLOP "
                f"({', '.join(f'{k} {v:.3e}' for k, v in sorted(cc.flops_by_dtype.items()))}), "
                f"{cc.hbm_bytes:.4e} HBM bytes, kernels {cc.kernels} "
                f"(traced in {secs:.1f} s): t_compute {terms.t_compute * 1e3:.3f} ms, "
                f"t_memory {terms.t_memory * 1e3:.3f} ms, bound "
                f"{bound:.3f} ms ({terms.bottleneck}); measured {ms:.3f} ms "
                f"({bound / ms:.4f} of it); argument + temp "
                f"{counted / 2**30:.3f} GiB (arguments {cc.argument_bytes / 2**30:.3f}; "
                f"the card's {card_args / 2**30:.3f}), card peak of the "
                f"first step {peak / 2**30:.3f} GiB ({held / 2**30:.3f} "
                f"GiB more held after it), ratio {ratio:.4f} (band "
                f"{MEMORY_RATIO})")
            if ms < bound:
                raise AssertionError(f"{arch} {kind}: measured {ms} ms beats "
                                     f"the counted bound {bound} ms")
            if not MEMORY_RATIO[0] <= ratio <= MEMORY_RATIO[1]:
                raise AssertionError(f"{arch} {kind}: card peak over the "
                                     f"count {ratio} outside {MEMORY_RATIO}")
    finally:
        tdist.destroy_process_group()


def start_full_dryrun(path):
    """Phase 11 (iii), started: ``python -m repro_torch.launch.dryrun --all
    --mesh DRYRUN_MESH --out path`` in a process of its own (CPU only, on
    meta tensors), run beside (i) and (ii)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "src"))
    log_f = open(path + ".log", "w")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                             "--all", "--mesh", DRYRUN_MESH, "--out", path],
                            env=env, stdout=log_f, stderr=subprocess.STDOUT)
    return proc, log_f, time.time()


def finish_full_dryrun(proc, log_f, t0, path):
    """Phase 11 (iii), checked: no row with status error, every cell's
    status as ``cell_is_runnable`` says."""
    from repro_torch.configs import ARCH_IDS, SHAPES, cell_is_runnable
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_f.close()
    wall = time.time() - t0
    if rc != 0:
        with open(path + ".log") as f:
            raise AssertionError(f"full dry run exited {rc}: "
                                 f"{f.read()[-3000:]}")
    with open(path) as f:
        rows = json.load(f)
    meshes = ["single", "multi"] if DRYRUN_MESH == "both" else [DRYRUN_MESH]
    want = {(a, s, m): "ok" if cell_is_runnable(get_config(a), SHAPES[s])[0]
            else "skipped" for a in ARCH_IDS for s in SHAPES for m in meshes}
    got = {(r["arch"], r["shape"], r["mesh"]): r["status"] for r in rows}
    if got != want:
        bad = {k: (got.get(k), v) for k, v in want.items()
               if got.get(k) != v}
        raise AssertionError(f"full dry run statuses differ: {bad}")
    ok = [r for r in rows if r["status"] == "ok"]
    log(f"phase 11 (iii) full dry run --all --mesh {DRYRUN_MESH}: "
        f"{len(rows)} rows, {len(ok)} ok, {len(rows) - len(ok)} skipped, "
        f"none in error, statuses as cell_is_runnable; wall {wall:.1f} s "
        f"(in a process of its own, beside (i) and (ii)); sum of the cells'"
        f" lower_s {sum(r['lower_s'] for r in ok):.1f} s")


def serving_mesh_phase():
    t0 = time.time()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "dryrun_results_torch.json")
        proc, log_f, t1 = start_full_dryrun(path)
        try:
            serving_mesh()
            dryrun_against_card()
        except BaseException:
            proc.kill()
            proc.wait()
            log_f.close()
            raise
        finish_full_dryrun(proc, log_f, t1, path)
    log(f"phase 11 wall time {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 4a: ML jobs through the bridge
# ---------------------------------------------------------------------------
# examples/schedule_training_cluster.py's fallback_jobs(): arch, shape,
# workers, steps, FLOP a step a worker, bytes a step a worker, GB a worker
BRIDGE_JOBS = (("smollm-360m", "train_4k", 6, 10, 1.5e14, 5e9, 4.0),
               ("qwen2.5-3b", "train_4k", 6, 10, 1.2e14, 7e9, 8.0),
               ("olmoe-1b-7b", "train_4k", 6, 10, 6e13, 9e9, 8.0))


def bridge_state(cfg, device):
    """The example's testbed with its jobs at its work-unit clock (the JAX
    package's default ``gpu_speed_flops``, 197e12)."""
    spec, net = build_paper_network(cfg, bw=10000.0, device=device)
    jobs = [bridge.MLJobSpec(*j) for j in BRIDGE_JOBS]
    return spec, init_sim(build_paper_hosts(device=device),
                          bridge.workload_from_jobs(
                              jobs, cfg, gpu_speed_flops=197e12,
                              device=device), net)


def bridge_phase():
    """Phase 4a: the example's ML jobs (18 containers) on its testbed
    (paper hosts, the Fig 3 fabric at bw 10000, horizon 220, 10 containers
    a host) for round, performance_first, jobgroup and netaware: launch
    counts reset before each run and read after (one seg_waterfill a
    tick), the card against the port's CPU run as phase 4 holds them."""
    cfg = SimConfig(horizon=220, max_containers_per_host=10)
    for policy in ("round", "performance_first", "jobgroup", "netaware"):
        spec, sim0 = bridge_state(cfg, DEV)
        reset_launch_counts()
        t0 = time.perf_counter()
        final, metrics = run_sim(sim0, cfg, get_policy(policy, device=DEV),
                                 spec.n_hosts, spec.n_nodes, cfg.horizon)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        if counts != sim_launches(cfg.horizon, 0, cfg.horizon):
            raise AssertionError(f"bridge {policy}: launch counts {counts}")
        rep = summarize(final, metrics)
        if rep["n_completed"] <= 0:
            raise AssertionError(f"bridge {policy}: nothing completed")
        spec_c, sim_c = bridge_state(cfg, "cpu")
        ref, ref_m = run_sim(sim_c, cfg, get_policy(policy, device="cpu"),
                             spec_c.n_hosts, spec_c.n_nodes, cfg.horizon)
        assert_state_close(final, ref, rtol=1e-5, atol=1e-4)
        assert_state_close(metrics, ref_m, rtol=1e-4, atol=1e-4)
        log(f"bridge {policy:18s}: completed {rep['n_completed']}/"
            f"{sim0.containers.status.shape[0]}, avg runtime "
            f"{rep['avg_runtime']:.2f}, avg comm {rep['avg_comm_time']:.2f},"
            f" {cfg.horizon / wall:.3f} ticks/s, launches {counts}, matches "
            f"the CPU run")


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
        t0 = time.perf_counter()
        final, metrics = run_sim(sim0, cfg, get_policy(policy, device=DEV),
                                 spec.n_hosts, spec.n_nodes, cfg.horizon)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        rep = summarize(final, metrics)
        want_fw = cfg.horizon // cfg.delay_update_interval if mode == "fw" \
            else 0
        if counts != sim_launches(cfg.horizon, want_fw, cfg.horizon):
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
            f"{rep['total_cost']:.1f}, {cfg.horizon / wall:.3f} ticks/s, "
            f"launches {counts}, matches the CPU run")


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

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    final, metrics, wall = once()
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if counts["seg_waterfill"] != horizon or counts["fw_minplus"] < 1 \
            or counts["place_round"] != horizon:
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
    return dict(counts=counts, setup=(cfg, spec, sim0, policy), final=final,
                metrics=metrics, peak_above=peak - base)


def streaming_run(real, chunk=16):
    """Phase 5a: phase 5's run streamed in chunks of ``chunk`` ticks, then
    timed against the stacked run in turns, then the fold timed alone.
    Peak memory is stated above what was allocated at each run's start:
    phase 5's final state is still held."""
    cfg, spec, sim0, policy = real["setup"]
    horizon = cfg.horizon

    def once(plan):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = run_sim(sim0, cfg, policy, spec.n_hosts, spec.n_nodes, horizon,
                      plan=plan)
        torch.cuda.synchronize()
        return (out, horizon / (time.time() - t0),
                (torch.cuda.max_memory_allocated() - base) / 2**20)

    streamed = ExecPlan(chunk=chunk)
    reset_launch_counts()
    (final, online), _, _ = once(streamed)
    counts = dict(LAUNCHES)
    want_fw = len(range(0, horizon, cfg.delay_update_interval))
    if counts != sim_launches(horizon, want_fw, horizon):
        raise AssertionError(f"streamed real-size run launch counts {counts}")
    la, lb = _leaves(real["final"]), _leaves(final)
    bad = [k for k in la if not torch.equal(la[k], lb[k])]
    if bad:
        raise AssertionError(f"streamed final state differs from phase 5's "
                             f"in {bad}")
    check_online(online, online_from_metrics(real["metrics"]),
                 "streamed real-size run")
    del final, online
    turns = {"streamed": [], "stacked": []}
    for name in ("streamed", "stacked", "stacked", "streamed") * 2:
        _, rate, mib = once(streamed if name == "streamed" else None)
        turns[name].append((rate, mib))
    sizes = ", ".join(str(min(chunk, horizon - t))
                      for t in range(0, horizon, chunk))
    ratios = [a[0] / b[0] for a, b in zip(turns["streamed"], turns["stacked"])]
    log(f"real size streamed, chunk {chunk} ({sizes} ticks), in turns "
        f"(ticks/s, peak MiB above the run's start): streamed "
        f"{'; '.join(f'{r:.3f}, {m:.1f}' for r, m in turns['streamed'])}; "
        f"stacked {'; '.join(f'{r:.3f}, {m:.1f}' for r, m in turns['stacked'])};"
        f" streamed / stacked by turn pair "
        f"{', '.join(f'{r:.4f}' for r in ratios)}; launches {counts}; "
        f"final state bit-identical to phase 5's, summary equal to its "
        f"series' fold")
    metrics = real["metrics"]
    ticks = [TickMetrics(*(x[t] for x in metrics)) for t in range(horizon)]
    acc = stats.acc_init(DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for m in ticks:
        acc = stats.acc_update(acc, m)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3 / horizon
    t0 = time.perf_counter()
    for _ in range(10):
        stats.online_fold(stats.online_init(), acc)
    fold_ms = (time.perf_counter() - t0) * 1e3 / 10
    log(f"real size fold alone: acc_update {update_ms:.4f} ms a tick (host "
        f"clock, {horizon} ticks of phase 5's series), online_fold "
        f"{fold_ms:.4f} ms a chunk (one device-to-host copy, 10 calls)")
    return counts


def check_online(got: OnlineSummary, want: OnlineSummary, what: str):
    """Integer fields exactly, float fields within rtol 3e-6."""
    for f, a, b in zip(OnlineSummary._fields, got, want):
        if np.issubdtype(np.asarray(b).dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {f}")
        else:
            np.testing.assert_allclose(a, b, rtol=3e-6, err_msg=f"{what}: {f}")


INT_KEYS = ("n_containers", "n_completed", "total_migrations",
            "total_arrivals", "total_decisions", "total_migration_starts",
            "flow_ticks", "peak_running", "peak_deployed", "peak_overloaded",
            "peak_queue")


def check_row(got: dict, want: dict, what: str):
    """Summary rows: integer keys exactly, float keys within rtol 3e-6."""
    for k, v in want.items():
        if k in INT_KEYS or not isinstance(v, float):
            if got[k] != v:
                raise AssertionError(f"{what}: {k} {got[k]} != {v}")
        elif not (np.isnan(v) and np.isnan(got[k])):
            np.testing.assert_allclose(got[k], v, rtol=3e-6,
                                       err_msg=f"{what}: {k}")


# the JAX package's tracked sweep point (benchmarks/engine_bench.py
# QUICK_SWEEP, bench_scenarios), restated: the script imports no JAX
SWEEP_SCENARIOS = (ScenarioSpec("baseline"),
                   ScenarioSpec("slow_net", bw=200.0),
                   ScenarioSpec("lossy_net", bw=500.0, loss=0.02),
                   ScenarioSpec("tight", overload_threshold=0.5,
                                queue_coef=1.0))


def sweep_point(H=50, C=300, horizon=40):
    """The sweep point's config and topology sizes."""
    cfg = SimConfig(n_jobs=max(10, C // 3), n_tasks=C, n_containers=C,
                    horizon=horizon, delay_mode="fw")
    n_leaf = max(4, H // 5)
    return cfg, dict(n_hosts=H, n_spine=max(2, n_leaf // 4), n_leaf=n_leaf)


# phase 5b's weight search: 4 samples, baseline, 20 hosts, horizon 20
TUNE_POINT = dict(n_samples=4, seeds=(0,), n_hosts=20, n_spine=2, n_leaf=4)


def sweep_phase(H=50, C=300, horizon=40, chunk=16, slab=5):
    """Phase 5b: the streamed policy x scenario sweep, three of its cells
    re-run standalone and timed against the sweep's runner, then a
    4-sample weight search.  Returns the sweep and the search."""
    cfg, grid = sweep_point(H, C, horizon)
    policies = list_policies()
    specs = list(SWEEP_SCENARIOS)
    B = len(policies) * len(specs)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.time()
    res = run_sweep(policies=policies, scenarios=specs, seeds=(0,), cfg=cfg,
                    plan=ExecPlan(chunk=chunk, slab=slab), device=DEV, **grid)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_fw = len(range(0, horizon, cfg.delay_update_interval))
    if counts != sim_launches(B * horizon, B * n_fw, B * horizon):
        raise AssertionError(f"sweep launch counts {counts} for {B} cells")
    rows = res.summaries()
    if not any(r["total_decisions"] for r in rows):
        raise AssertionError("the sweep placed nothing")
    log(f"sweep {len(policies)} policies x {len(specs)} scenarios x 1 seed "
        f"= {B} cells (slab {slab}, chunk {chunk}) at {H} hosts / {C} "
        f"containers, fw, horizon {horizon}: {res.wall_s} s without the "
        f"scenarios' build ({wall:.3f} s with it), {B / res.wall_s:.3f} "
        f"cells/s, {B * horizon / res.wall_s:.3f} ticks/s a cell, peak "
        f"device memory {peak / 2**20:.1f} MiB, launches {counts}")
    net_spec, sims, rps = build_scenarios(specs, cfg, seeds=(0,), device=DEV,
                                          **grid)
    pols = stack_policies(policies, device=DEV)
    runner = make_stream_fn(cfg, net_spec.n_hosts, net_spec.n_nodes, horizon,
                            chunk=chunk, slab=1)
    for b in (0, B // 2, B - 1):
        p, s = b // len(specs), b % len(specs)
        sim = tree_map(lambda x: x[s, 0], sims)
        rp = tree_map(lambda x: x[s], rps)
        pol = get_policy(policies[p], device=DEV)
        f, m = run_sim(sim, cfg, pol, net_spec.n_hosts, net_spec.n_nodes,
                       horizon, params=rp)
        g, online = run_sim(sim, cfg, pol, net_spec.n_hosts,
                            net_spec.n_nodes, horizon, params=rp,
                            plan=ExecPlan(chunk=chunk))
        cell = _leaves(tree_map(lambda x: x[p, s, 0], res.finals))
        what = f"sweep cell {b} ({policies[p]}, {specs[s].name})"
        for got, how in ((f, "stacked"), (g, "streamed")):
            bad = [k for k, v in _leaves(got).items()
                   if not np.array_equal(v.cpu().numpy(), cell[k])]
            if bad:
                raise AssertionError(f"{what}: finals differ from the "
                                     f"{how} standalone run in {bad}")
        check_row(rows[b], summarize(f, m), what)
        check_row(rows[b], summarize(g, online), what)

        def timed(solo):
            t1 = time.time()
            if solo:
                run_sim(sim, cfg, pol, net_spec.n_hosts, net_spec.n_nodes,
                        horizon, params=rp, plan=ExecPlan(chunk=chunk))
            else:
                next(runner.iter_slabs(sims, pols, rps, [b]))
            torch.cuda.synchronize()
            return horizon / (time.time() - t1)

        turns = [(solo, timed(solo)) for solo in (False, True, True, False)]
        log(f"{what}: equals its standalone run_sim, stacked and streamed "
            f"(finals bit-identical, rows equal); ticks/s in turns, the "
            f"sweep's runner {', '.join(f'{r:.3f}' for o, r in turns if not o)}"
            f" against standalone "
            f"{', '.join(f'{r:.3f}' for o, r in turns if o)}")
    t0 = time.time()
    tres = run_tune(scenarios=[ScenarioSpec("baseline")],
                    cfg=SimConfig(horizon=20), device=DEV, **TUNE_POINT)
    torch.cuda.synchronize()
    if tres.scores.shape != (4,) or not np.isfinite(tres.scores).all():
        raise AssertionError(f"tune scores {tres.scores}")
    log(f"tune 4 samples, baseline, 20 hosts, horizon 20: "
        f"{time.time() - t0:.3f} s, {tres.objective} "
        f"{', '.join(f'{v:.4f}' for v in tres.scores)}, best sample "
        f"{tres.best}")
    return res, tres


# ---------------------------------------------------------------------------
# Phase 5e: the multi-process sweep fabric on the card
# ---------------------------------------------------------------------------
def check_same_sweep(got_finals, got_summary, want_finals, want_summary,
                     what):
    """Finals and summary bit-identical (host numpy leaves both)."""
    bad = [k for k, v in _leaves(got_finals).items()
           if not np.array_equal(np.asarray(v).view(np.uint8),
                                 np.asarray(_leaves(want_finals)[k])
                                 .view(np.uint8))]
    bad += [f for f, a, b in zip(OnlineSummary._fields, got_summary,
                                 want_summary)
            if a.dtype != b.dtype or not np.array_equal(a.view(np.uint8),
                                                        b.view(np.uint8))]
    if bad:
        raise AssertionError(f"{what}: differs in {bad}")


def check_workers(metas, cells, horizon, n_fw, starts, what):
    """The workers' summed launches, their slabs (each claimed once) and
    their devices (the card, the kernels on)."""
    summed = {k: sum(m["launches"][k] for m in metas) for k in LAUNCHES}
    check_launches(summed, cells, horizon, n_fw, what)
    slabs = sorted(s for m in metas for s in m["slabs"])
    if slabs != starts:
        raise AssertionError(f"{what}: workers claimed {slabs}, the plan "
                             f"has {starts}")
    card = torch.cuda.get_device_name(0)
    for m in metas:
        if (m["backend"] != "torch-cuda" or set(m["device_names"]) != {card}
                or not all(m["kernels_active"].values())):
            raise AssertionError(f"{what}: worker meta {m}")
    return summed


def fabric_phase(sweep, tune, H=50, C=300, horizon=40, chunk=16, slab=5):
    """Phase 5e: (i) phase 5b's sweep through 2 worker processes on the
    card; (ii) a resume with devices_per_proc=2; (iii) phase 5b's tune
    with procs=2."""
    cfg, grid = sweep_point(H, C, horizon)
    policies, specs = list_policies(), list(SWEEP_SCENARIOS)
    B = len(policies) * len(specs)
    n_fw = len(range(0, horizon, cfg.delay_update_interval))
    with tempfile.TemporaryDirectory(prefix="fabric_") as out:
        t0 = time.time()
        res = run_dist_sweep(policies=policies, scenarios=specs, seeds=(0,),
                             cfg=cfg, plan=ExecPlan(chunk=chunk, slab=slab,
                                                    procs=2),
                             out_dir=out, device=DEV, timeout_s=300.0,
                             **grid)
        wall = time.time() - t0
        with open(os.path.join(out, "coordinator.json")) as f:
            coord = json.load(f)
    check_same_sweep(res.finals, res.summary, sweep.finals, sweep.summary,
                     "fabric sweep against phase 5b")
    summed = check_workers(res.worker_meta, B, horizon, n_fw,
                           list(range(0, B, slab)), "fabric sweep")
    log(f"fabric sweep, 2 workers on one card, {B} cells (slab {slab}, "
        f"chunk {chunk}): bit-identical to phase 5b; {res.wall_s} s spawn "
        f"to merge ({wall:.3f} s with the launcher's build), "
        f"{B / res.wall_s:.3f} cells/s against phase 5b's "
        f"{B / sweep.wall_s:.3f} in-process ({sweep.wall_s} s); workers' "
        f"launches {summed}; coordinator: stragglers {coord['stragglers']}, "
        f"median slab {coord['median_slab_s']} s, assignments "
        f"{coord['assignments']}")
    for m in res.worker_meta:
        cells = sum(min(slab, B - s) for s in m["slabs"])
        log(f"  worker {m['process_index']} on {m['devices']}: start-up "
            f"{m['startup_s']} s, slabs {m['slabs']}, walls "
            f"{m['slab_walls_s']} s, loop {m['wall_s']} s, {cells} cells, "
            f"{cells / max(sum(m['slab_walls_s']), 1e-9):.3f} cells/s over "
            f"its slab walls, launches {m['launches']}")

    # (ii) resume with two devices a worker: slab 5 pads to 6
    plan = ExecPlan(chunk=chunk, slab=slab, procs=2, devices_per_proc=2)
    sub = policies[:2]
    Bs = len(sub) * len(specs)
    spec = GridSpec.build(cfg=cfg, scenarios=specs, seeds=(0,), policies=sub,
                          chunk=chunk, slab=slab, overlap=True,
                          devices_per_proc=2, **grid)
    ref = run_sweep(policies=sub, scenarios=specs, seeds=(0,), cfg=cfg,
                    plan=ExecPlan(chunk=chunk, slab=slab,
                                  devices=(DEV, DEV)), device=DEV, **grid)
    with tempfile.TemporaryDirectory(prefix="fabric_resume_") as out:
        first = run_worker_inline(spec, out, 0, [0], device=DEV)
        os.remove(os.path.join(out, "worker_00.json"))
        run = run_spec(spec, num_procs=plan.procs, out_dir=out, device=DEV,
                       timeout_s=300.0)
    check_same_sweep(run.finals, run.summary, ref.finals, ref.summary,
                     "fabric resume against the in-process sweep")
    check_workers(run.metas + [first], Bs, horizon, n_fw, [0, 6],
                  "fabric resume")
    log(f"fabric resume, devices_per_proc 2 ({first['devices']}), {Bs} "
        f"cells, slab {slab} padded to 6: slab 0 in this process "
        f"(orphaned), {[m['slabs'] for m in run.metas]} by the workers; "
        f"bit-identical to the in-process sweep on (cuda:0, cuda:0); "
        f"{run.wall_s} s spawn to merge")

    # (iii) the weight search through the fabric
    t0 = time.time()
    dres = run_tune(scenarios=[ScenarioSpec("baseline")],
                    cfg=SimConfig(horizon=20), device=DEV,
                    plan=ExecPlan(chunk=10, procs=2), **TUNE_POINT)
    if not np.array_equal(dres.scores, tune.scores):
        raise AssertionError(f"fabric tune scores {dres.scores} against "
                             f"phase 5b's {tune.scores}")
    log(f"fabric tune, 4 samples over 2 workers (chunk 10): "
        f"{time.time() - t0:.3f} s, scores equal to phase 5b's")


# ---------------------------------------------------------------------------
# Phase 5c: the differentiated sweep and the gradient search
# ---------------------------------------------------------------------------
# the JAX package's test config of the gradient search
# (tests/test_autodiff.py small_cfg), restated: the script imports no JAX
GRAD_SMALL = dict(n_jobs=10, n_tasks=40, n_containers=40, horizon=30,
                  arrival_window=10.0, placements_per_tick=16,
                  migrations_per_tick=2)
# the two weights the delay refresh carries into net.comm_cost: a chunked
# gradient truncates them at a chunk boundary inside the admit window
CACHE_DIMS = [weight_index("util"), weight_index("cross_leaf")]


def offset_netaware(device) -> PolicyParams:
    """netaware's weights plus the JAX package's finite-difference test's
    offsets (rng 11, uniform 0.05-0.4 on four row weights), which take the
    point off the built-in vector's ties; [1, W]."""
    w = get_policy("netaware", device="cpu").weights.numpy().copy()
    dims = [weight_index(n) for n in ("row_comm", "row_coloc",
                                      "row_worst_fit", "row_cross_leaf")]
    w[dims] += np.random.default_rng(11).uniform(
        0.05, 0.4, len(dims)).astype(np.float32)
    return PolicyParams(weights=torch.tensor(w[None], device=device))


def measured(fn):
    """(fn's result, wall s, peak device MiB above the start, launches) of
    one call, the launch counts reset just before it."""
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            (torch.cuda.max_memory_allocated() - base) / 2**20,
            dict(LAUNCHES))


def sim_launches(seg, fw, place=0):
    """A simulator run's launch counts: ``place`` place_round (one an admit
    round, none where the soft surrogate takes the plain loop)."""
    return {"seg_waterfill": seg, "fw_minplus": fw, "flash_attention": 0,
            "ssd_scan": 0, "place_round": place}


def check_launches(counts, cells, horizon, n_fw, what, place=True):
    want = sim_launches(cells * horizon, cells * n_fw,
                        cells * horizon if place else 0)
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, want {want}")


def grad_paper(horizon=40):
    """The paper testbed differentiated on the card against the port on
    the CPU: baseline and slow_net, the offset netaware weights."""
    cfg = SimConfig(horizon=horizon, delay_mode="fw", soft_placement=True)
    specs = [ScenarioSpec("baseline"), ScenarioSpec("slow_net", bw=200.0)]
    out = {}
    for key, dev in (("card", DEV), ("cpu", torch.device("cpu"))):
        net_spec, sims, rps = build_scenarios(specs, cfg, seeds=(0,),
                                              device=dev)
        pols = offset_netaware(dev)
        gfn = make_grad_fn(cfg, net_spec.n_hosts, net_spec.n_nodes, horizon)
        (v, g), wall, _, counts = measured(lambda: gfn(sims, pols, rps))
        finals, _ = make_sweep_fn(cfg, net_spec.n_hosts, net_spec.n_nodes,
                                  horizon)(sims, pols, rps)
        out[key] = (v.cpu(), g.cpu(), finals, counts, wall)
    v, g, finals, counts, wall = out["card"]
    rv, rg, rfinals, _, rwall = out["cpu"]
    n_fw = len(range(0, horizon, cfg.delay_update_interval))
    check_launches(counts, len(specs), horizon, n_fw, "paper gradient",
                   place=False)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=0)
    torch.testing.assert_close(g, rg, rtol=1e-4, atol=1e-6)
    assert_state_close(finals, rfinals, rtol=1e-5, atol=1e-4)
    if not bool(torch.isfinite(g).all()) or g.abs().max().item() == 0:
        raise AssertionError(f"paper gradient {g}")
    log(f"grad paper testbed, offset netaware x baseline, slow_net, fw, "
        f"horizon {horizon}, tau 1: value {v.item():.6f} on the card "
        f"({rv.item():.6f} on the CPU), gradient max |diff| "
        f"{(g - rg).abs().max().item():.3g} of max |g| "
        f"{g.abs().max().item():.4f}; hard finals equal the CPU's; "
        f"{wall:.3f} s on the card ({rwall:.3f} s on the CPU); launches "
        f"{counts}")


def grad_real(real, chunk=16):
    """Phase 5's run with the flag on: the soft forward against the flag-off
    run in turns, then the gradient of the offset netaware weights,
    stacked twice, taken apart into forward and backward, and chunked."""
    cfg0, spec, sim0, policy = real["setup"]
    cfg = dataclasses.replace(cfg0, soft_placement=True)
    horizon = cfg.horizon
    n_fw = len(range(0, horizon, cfg.delay_update_interval))
    H, N = spec.n_hosts, spec.n_nodes

    def flag_off():
        return run_sim(sim0, cfg0, policy, H, N, horizon)

    def soft_forward():
        with torch.no_grad():
            return run_sim(sim0, cfg, policy, H, N, horizon)

    turns = {"off": [], "soft": []}
    for name in ("off", "soft", "soft", "off") * 2:
        (final, metrics), wall, mib, counts = measured(
            flag_off if name == "off" else soft_forward)
        check_launches(counts, 1, horizon, n_fw, f"real size, {name}",
                       place=name == "off")
        la, lb = _leaves(real["final"]), _leaves(final)
        bad = [k for k in la if not torch.equal(la[k], lb[k])]
        bad += [f for f in TickMetrics._fields if not f.startswith("soft_")
                and not torch.equal(getattr(metrics, f),
                                    getattr(real["metrics"], f))]
        if bad:
            raise AssertionError(f"real size {name}: differs from phase 5's "
                                 f"flag-off run in {bad}")
        if name == "soft" and metrics.soft_n.sum().item() == 0:
            raise AssertionError("real-size soft forward made no decision")
        turns[name].append((wall, mib))
        del final, metrics
    sims = tree_map(lambda x: x[None, None], sim0)
    rp = cfg.run_params(DEV)
    rps = tree_map(lambda x: x[None], rp)
    pols = offset_netaware(DEV)
    gfn = make_grad_fn(cfg, H, N, horizon)
    (v, g), wall_s, mib_s, counts = measured(lambda: gfn(sims, pols, rps))
    check_launches(counts, 1, horizon, n_fw, "real-size stacked gradient",
                   place=False)
    row_comm = weight_index("row_comm")
    if not bool(torch.isfinite(g).all()) or g[0, row_comm].item() == 0:
        raise AssertionError(f"real-size stacked gradient {g}")
    (v2, g2), wall_s2, mib_s2, counts = measured(
        lambda: gfn(sims, pols, rps))
    check_launches(counts, 1, horizon, n_fw, "second stacked gradient",
                   place=False)
    if not (torch.equal(v, v2) and torch.equal(g, g2)):
        raise AssertionError("second real-size stacked gradient differs: "
                             f"max {(g - g2).abs().max().item()}")
    # the same stacked cell taken apart: forward (recording the graph) and
    # backward timed apart
    w = pols.weights[0].detach().clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = engine.simulate(sim0, cfg, PolicyParams(weights=w), H, N,
                           horizon, rp)
    value = stats.soft_objective(m)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g3, = torch.autograd.grad(value, w)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not torch.equal(g3, g[0]):
        raise AssertionError("the stacked gradient taken apart differs")
    del m, value
    (vc, gc), wall_c, mib_c, counts = measured(
        lambda: make_grad_fn(cfg, H, N, horizon, chunk=chunk)(sims, pols,
                                                              rps))
    check_launches(counts, 1, horizon, n_fw, "chunked gradient",
                   place=False)
    torch.testing.assert_close(vc, v, rtol=1e-5, atol=0)
    exact = torch.ones(g.shape[1], dtype=torch.bool, device=g.device)
    exact[CACHE_DIMS] = False
    torch.testing.assert_close(gc[:, exact], g[:, exact], rtol=1e-4,
                               atol=1e-7)
    fmt = lambda xs: "; ".join(f"{a:.3f} s, {b:.1f} MiB" for a, b in xs)
    pairs = list(zip(turns["soft"], turns["off"]))
    log(f"grad real size {H} hosts / {cfg.n_containers} containers, fw, "
        f"horizon "
        f"{horizon}, tau 1, in turns (wall, peak MiB above the start): "
        f"flag off {fmt(turns['off'])}; soft forward under no_grad "
        f"{fmt(turns['soft'])} (hard finals and metrics bit-identical to "
        f"phase 5's); soft / off wall by turn pair "
        f"{', '.join('%.4f' % (a[0] / b[0]) for a, b in pairs)}")
    log(f"grad real size, offset netaware: stacked forward + backward "
        f"{wall_s:.3f} s and {wall_s2:.3f} s, peak {mib_s:.1f} and "
        f"{mib_s2:.1f} MiB, bit-identical; taken apart: forward with the "
        f"graph {t1 - t0:.3f} s, backward {t2 - t1:.3f} s, backward share "
        f"{(t2 - t1) / (t2 - t0):.4f}; chunked ({chunk}) {wall_c:.3f} s, "
        f"peak {mib_c:.1f} MiB, value within rtol 1e-5 and gradient off "
        f"util/cross_leaf within rtol 1e-4 of the stacked (util "
        f"{gc[0, CACHE_DIMS[0]].item():.6g} against "
        f"{g[0, CACHE_DIMS[0]].item():.6g}); value {v.item():.6f}, "
        f"d/d row_comm {g[0, row_comm].item():.6g}; launches a pass "
        f"{counts}")


def grad_tune():
    """The gradient search at the JAX package's test parameters, slow_net:
    the best oracle score finite and no worse than the incumbent's."""
    cfg = SimConfig(**GRAD_SMALL)
    scen = [ScenarioSpec("slow_net", bw=200.0)]
    t0 = time.time()
    res = run_tune_grad(steps=6, batch=4, eval_every=3, lr=0.3, cfg=cfg,
                        scenarios=scen, seeds=(0,), objective="avg_runtime",
                        seed=0, device=DEV)
    torch.cuda.synchronize()
    wall = time.time() - t0
    incumbent = run_tune(n_samples=1, cfg=cfg, scenarios=scen, seeds=(0,),
                         objective="avg_runtime", device=DEV).scores[0]
    if not (np.isfinite(res.best_oracle) and res.best_oracle <= incumbent):
        raise AssertionError(f"grad tune best {res.best_oracle} against the "
                             f"incumbent's {incumbent}")
    log(f"grad tune 6 steps x 4 candidates, slow_net, small config: "
        f"{wall:.3f} s, best oracle avg_runtime {res.best_oracle:.4f} "
        f"(incumbent {incumbent:.4f}), {res.oracle_evals} oracle + "
        f"{res.surrogate_evals} surrogate evals, surrogate means "
        f"{', '.join('%.5f' % h['surrogate_mean'] for h in res.history)}")


def autodiff_phase(real):
    grad_paper()
    grad_real(real)
    grad_tune()


# ---------------------------------------------------------------------------
# Phase 5d: event-horizon telescoping
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def telescope_meter():
    """Meter the telescoped engine for the runs inside the block: its
    macro steps (one per full tick: ``engine._advance`` follows each), the
    cheap ticks ``engine._cheap_ticks`` takes and the host time of both,
    each call closed by a synchronize.  Yields a dict of the totals."""
    advance, cheap = engine._advance, engine._cheap_ticks
    seen = {"steps": 0, "cheap": 0, "advance_s": 0.0, "cheap_s": 0.0}

    def timed(fn, key):
        def wrapper(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            seen[key] += time.perf_counter() - t0
            return out
        return wrapper

    def metered_cheap(sim, t, *rest):
        sim, t2 = timed(cheap, "cheap_s")(sim, t, *rest)
        seen["cheap"] += t2 - t
        return sim, t2

    def metered_advance(*args):
        seen["steps"] += 1
        return timed(advance, "advance_s")(*args)

    engine._advance, engine._cheap_ticks = metered_advance, metered_cheap
    try:
        yield seen
    finally:
        engine._advance, engine._cheap_ticks = advance, cheap


def differing_leaves(a, b):
    la, lb = _leaves(a), _leaves(b)
    return [k for k in la if not torch.equal(la[k], lb[k])]


def telescoped_run(run, horizon, n_fw, what):
    """One metered telescoped run: (its output, wall s, full ticks, the
    meter's totals); the launches checked against the full ticks (one
    seg_waterfill each) and ``n_fw`` fw_minplus."""
    with telescope_meter() as meter:
        out, wall, _, counts = measured(run)
    n_full = horizon - meter["cheap"]
    if meter["steps"] != n_full:
        raise AssertionError(f"{what}: {meter['steps']} macro steps, but "
                             f"{meter['cheap']} of {horizon} ticks cheap")
    check_launches(counts, 1, n_full, n_fw, what)
    return out, wall, n_full, meter


def telescope_phase(real, horizon=400, interval=100, chunk=128):
    """Phase 5d: (i) phase 5's run telescoped, against phase 5's; (ii) the
    same fleet and workload over a drained tail (``horizon`` ticks, a
    refresh every ``interval``, chunks of ``chunk``), streamed per tick
    and telescoped in turns."""
    cfg, spec, sim0, policy = real["setup"]
    H, N = spec.n_hosts, spec.n_nodes
    n_fw = len(range(0, cfg.horizon, cfg.delay_update_interval))
    (final, online), wall, n_full, meter = telescoped_run(
        lambda: run_sim(sim0, cfg, policy, H, N, cfg.horizon,
                        plan=ExecPlan(telescope=True)),
        cfg.horizon, n_fw, "telescoped real-size run")
    bad = differing_leaves(real["final"], final)
    if bad:
        raise AssertionError(f"telescoped final state differs from phase "
                             f"5's in {bad}")
    check_online(online, online_from_metrics(real["metrics"]),
                 "telescoped real-size run")
    log(f"telescope real size, fw, netaware, horizon {cfg.horizon}, refresh "
        f"every {cfg.delay_update_interval}: {n_full} full ticks of "
        f"{cfg.horizon}, {cfg.horizon / wall:.3f} ticks/s ({wall:.3f} s); "
        f"final state bit-identical to phase 5's, summary equal to its "
        f"series' fold; launches {n_full} seg_waterfill, {n_fw} fw_minplus")
    del final, online
    tail = dataclasses.replace(cfg, horizon=horizon,
                               delay_update_interval=interval)
    n_fw = len(range(0, horizon, interval))
    plans = {"per tick": ExecPlan(chunk=chunk),
             "telescoped": ExecPlan(chunk=chunk, telescope=True)}
    firsts, turns = {}, {name: [] for name in plans}
    for name in ("per tick", "telescoped", "telescoped", "per tick"):
        def go():
            return run_sim(sim0, tail, policy, H, N, horizon,
                           plan=plans[name])
        if name == "per tick":
            out, wall, _, counts = measured(go)
            check_launches(counts, 1, horizon, n_fw, "drained tail, per tick")
            n_full, meter = horizon, None
        else:
            out, wall, n_full, meter = telescoped_run(
                go, horizon, n_fw, "drained tail, telescoped")
        if name in firsts:
            bad = differing_leaves(firsts[name][0], out[0])
            if bad:
                raise AssertionError(f"drained tail, {name}: second run's "
                                     f"final state differs in {bad}")
        firsts.setdefault(name, out)
        turns[name].append((horizon / wall, n_full, meter))
    (f_off, s_off), (f_on, s_on) = firsts["per tick"], firsts["telescoped"]
    bad = differing_leaves(f_off, f_on)
    if bad:
        raise AssertionError(f"drained tail: telescoped final state differs "
                             f"from the per-tick one in {bad}")
    check_online(s_on, s_off, "drained tail")
    n_full = turns["telescoped"][0][1]
    if n_full >= horizon:
        raise AssertionError(f"drained tail: {n_full} full ticks of "
                             f"{horizon}, nothing telescoped")
    rep = summarize(f_on, s_on)
    per_cheap = [m["cheap_s"] / max(m["cheap"], 1) * 1e6
                 for _, _, m in turns["telescoped"]]
    per_step = [(m["advance_s"] - m["cheap_s"]) / m["steps"] * 1e3
                for _, _, m in turns["telescoped"]]
    ratios = [a[0] / b[0] for a, b in zip(turns["telescoped"],
                                          turns["per tick"])]
    log(f"telescope drained tail, fw, netaware, horizon {horizon}, refresh "
        f"every {interval}, chunk {chunk}, in turns (ticks/s): per tick "
        f"{', '.join(f'{r:.3f}' for r, _, _ in turns['per tick'])}; "
        f"telescoped "
        f"{', '.join(f'{r:.3f}' for r, _, _ in turns['telescoped'])}; "
        f"telescoped / per tick by turn pair "
        f"{', '.join(f'{r:.4f}' for r in ratios)}; {n_full} full ticks of "
        f"{horizon} (completed {rep['n_completed']} of {rep['n_containers']},"
        f" the last finish at tick "
        f"{f_on.containers.finish_t.max().item():.0f}); host time a cheap "
        f"tick {', '.join(f'{u:.1f}' for u in per_cheap)} us, the "
        f"quiescence test "
        f"and fold a full tick {', '.join(f'{u:.3f}' for u in per_step)} ms; "
        f"finals bit-identical, summaries equal; launches a telescoped run "
        f"{n_full} seg_waterfill, {n_fw} fw_minplus")


def _leaves(t, prefix=""):
    out = {}
    for k, v in t._asdict().items():
        if isinstance(v, tuple):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def main():
    t_start = time.time()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.time()
    _build.build()
    log(f"built kernels {list(_build.SOURCES)} in {time.time() - t0:.2f} s")
    for name in _build.SOURCES:
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
    bridge_phase()
    real = real_size_run()
    sim_counts = real["counts"]
    streaming_run(real)
    sweep, tune = sweep_phase()
    fabric_phase(sweep, tune)
    del sweep
    autodiff_phase(real)
    telescope_phase(real)
    del real
    reduced_serve()
    reduced_families()
    lm_counts = full_width_serve()
    for k, v in families_phase().items():
        lm_counts[k] += v
    for k, v in train_phase().items():
        lm_counts[k] += v
    for k, v in moe_training_phase().items():
        lm_counts[k] += v
    serving_mesh_phase()
    check_waterfill_launches(real_net, 2000)
    check_fw_launches()
    for name, row in rows.items():
        lm = name in ("flash_attention", "ssd_scan")
        row.setdefault("launches", (lm_counts if lm else sim_counts)[name])

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"chip_smoke wall time {time.time() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": [rows[k] for k in _build.SOURCES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(sys.argv[2:])
    elif sys.argv[1:2] == ["--serve-worker"]:
        serve_worker(sys.argv[2:])
    else:
        main()
