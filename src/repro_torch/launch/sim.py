"""DCSim CLI on PyTorch: run the paper's container-scheduling simulation.

    PYTHONPATH=src python -m repro_torch.launch.sim --policy jobgroup
    PYTHONPATH=src python -m repro_torch.launch.sim --policy all --bw 200
    PYTHONPATH=src python -m repro_torch.launch.sim --hosts 2000 \\
        --containers 6000 --horizon 40 --delay-mode fw --policy netaware
    PYTHONPATH=src python -m repro_torch.launch.sim --device cpu --chunk 16
    PYTHONPATH=src python -m repro_torch.launch.sim --policy netaware \\
        --weights cross_leaf=0.5,row_coloc=0.3

The flags are those of ``python -m repro.launch.sim``, the execution ones
from ``launch.execargs`` (``--chunk`` streams the run with online
summaries; ``--telescope`` raises until its slice is ported), plus
``--device`` (default ``cuda``; without a CUDA device the run fails unless
``--device cpu`` is given).  Every report row records the backend and
device it ran on and whether the delay and waterfill hot paths went
through their CUDA kernels.  The policy x scenario x seed grid lives in
``repro_torch.launch.sweep``, weight search in ``repro_torch.launch.tune``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import (ExecPlan, SimConfig, build_paper_hosts,
                              build_paper_network, get_policy, init_sim,
                              list_policies, paper_workload, run_sim,
                              scaled_hosts, summarize, to_csv, trace_workload)
from repro_torch.core.report import json_clean
from repro_torch.core.types import device_name, resolve_device
from repro_torch.kernels import resolve_kernel
from repro_torch.launch.execargs import add_exec_args


def build_once(cfg: SimConfig, bw=None, loss=None, seed=0, workload="paper",
               n_hosts=20, device=None):
    """Hosts + network + workload + initial state, built once and shared by
    every policy; the bw/loss overrides ride the RunParams."""
    if bw is not None and bw <= 0:
        raise ValueError(f"--bw must be > 0 Mbps, got {bw}")
    if loss is not None and loss < 0:
        raise ValueError(f"--loss must be >= 0, got {loss}")
    device = resolve_device(device)
    n_leaf = max(4, n_hosts // 5)
    hosts = (build_paper_hosts(device=device) if n_hosts == 20
             else scaled_hosts(n_hosts, n_leaf, device=device))
    spec, net = build_paper_network(cfg, n_hosts=n_hosts, n_leaf=n_leaf,
                                    device=device)
    gen = paper_workload if workload == "paper" else trace_workload
    sim0 = init_sim(hosts, gen(cfg, seed=seed, device=device), net)
    params = cfg.run_params(device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    params = params._replace(**{k: f32(v) for k, v in
                                (("bw_mbps", bw), ("loss", loss))
                                if v is not None})
    return spec, sim0, params


def parse_weights(arg: str | None) -> dict[str, float] | None:
    """``"cross_leaf=0.5,row_coloc=0.3"`` -> by-name override dict
    (validated against ``types.WEIGHT_NAMES`` by ``get_policy``)."""
    if not arg:
        return None
    out = {}
    for item in arg.split(","):
        name, _, val = item.partition("=")
        if not _:
            raise ValueError(f"--weights items must be name=value, "
                             f"got {item!r}")
        out[name.strip()] = float(val)
    return out


def run_one(policy_name: str, cfg: SimConfig, spec, sim0, params, csv=None,
            weights=None, plan: ExecPlan | None = None):
    plan = ExecPlan() if plan is None else plan
    if csv and plan.chunk is not None:
        raise ValueError("--csv needs the stacked per-tick series; "
                         "drop --chunk to export one")
    cfg = plan.apply_to_config(cfg)
    device = sim0.t.device
    t0 = time.time()
    final, metrics = run_sim(sim0, cfg,
                             get_policy(policy_name, weights, device=device),
                             spec.n_hosts, spec.n_nodes, cfg.horizon,
                             params=params, plan=plan)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rep = summarize(final, metrics)   # stacked series or OnlineSummary
    rep["policy"] = policy_name
    rep["wall_s"] = round(time.time() - t0, 2)
    rep["backend"] = "torch-" + device.type
    rep["device"] = device_name(device)
    rep["delay_mode"] = cfg.delay_mode
    rep["delay_kernel"] = cfg.delay_kernel
    rep["delay_kernel_active"] = (cfg.delay_mode == "fw"
                                  and resolve_kernel(cfg.delay_kernel, device))
    rep["waterfill_kernel"] = cfg.waterfill_kernel
    rep["waterfill_kernel_active"] = (
        cfg.sparse_flows and resolve_kernel(cfg.waterfill_kernel, device))
    if csv:
        to_csv(metrics, csv)
    return rep


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="all",
                    help=f"one of {list_policies()} or 'all'")
    ap.add_argument("--horizon", type=int, default=120)
    ap.add_argument("--hosts", type=int, default=20,
                    help="fleet size (paper Table 5 mix, scaled)")
    ap.add_argument("--containers", type=int, default=None,
                    help="workload size (containers; jobs/tasks scale along)")
    ap.add_argument("--bw", type=float, default=None, help="link Mbps")
    ap.add_argument("--loss", type=float, default=None,
                    help="link loss fraction")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workload", default="paper",
                    choices=["paper", "trace"])
    ap.add_argument("--csv", default=None, help="per-tick metrics CSV path")
    ap.add_argument("--out", default=None,
                    help="write the summary reports as a JSON list")
    ap.add_argument("--sequential", action="store_true",
                    help="run the sequential reference placement path "
                         "instead of the batched round")
    ap.add_argument("--delay-mode", default="path", choices=["path", "fw"],
                    help="delay refresh: ECMP path sum or full APSP "
                         "(the fw_minplus kernel)")
    ap.add_argument("--weights", default=None,
                    help="by-name weight overrides for the policy, e.g. "
                         "cross_leaf=0.5,row_coloc=0.3 (types.WEIGHT_NAMES)")
    add_exec_args(ap, slab=False, devices=False, overlap=False)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    wl = ({} if args.containers is None else
          dict(n_containers=args.containers, n_tasks=args.containers,
               n_jobs=max(10, args.containers // 3)))
    cfg = SimConfig(horizon=args.horizon,
                    batched_placement=not args.sequential,
                    delay_mode=args.delay_mode, **wl)
    plan = ExecPlan.from_args(args)
    weights = parse_weights(args.weights)
    spec, sim0, params = build_once(cfg, bw=args.bw, loss=args.loss,
                                    seed=args.seed, workload=args.workload,
                                    n_hosts=args.hosts, device=args.device)
    policies = list_policies() if args.policy == "all" else [args.policy]
    reports = []
    for p in policies:
        rep = json_clean(run_one(p, cfg, spec, sim0, params, csv=args.csv,
                                 weights=weights, plan=plan))
        reports.append(rep)
        print(json.dumps(rep, indent=None, sort_keys=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(reports, f, indent=1)


if __name__ == "__main__":
    main()
