"""Where a tick's time goes: profile a steady window of ticks on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile \\
        --hosts 2000 --containers 6000 --delay-mode fw --policy netaware

Runs ``--warmup`` ticks, then ``--ticks`` ticks under ``torch.profiler``
(CPU and CUDA activity), and prints: the window's wall time and ticks/s
(host clock after a synchronize), the host time of each labelled tick phase
(``engine.make_tick_ext``), the kernel launches per tick, the device's busy
share (the union of the device-side events' intervals over wall time,
overlapping kernels counted once; "not measured" when the profiler sees
no device activity), the kernels and aten ops with the most device time,
and the port's own records of the window (``core/trace.py``): device
read-backs per tick by site, host ms of the admit round per candidate
(its read-back left out) and the share of candidates admitted.  The
profiler slows the host, so the window's ticks/s is lower than an
unprofiled run's.  The last line is the same as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import SimConfig, get_policy, network, trace
from repro_torch.core.engine import make_tick
from repro_torch.launch.sim import build_once

PHASES = ("phase_arrive", "phase_schedule", "phase_flows", "phase_progress",
          "delay_refresh", "stats_collect")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def _device_us(evt, self_only: bool) -> float:
    name = "self_device_time_total" if self_only else "device_time_total"
    legacy = "self_cuda_time_total" if self_only else "cuda_time_total"
    return float(getattr(evt, name, getattr(evt, legacy, 0.0)) or 0.0)


def union_ms(intervals) -> float:
    """Milliseconds covered by ``(start_us, end_us)`` intervals, those
    that overlap counted once."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total / 1e3


def device_summary(events, exclude=()):
    """(kernel launches, {device event name: [ms, count]}, device ms) of a
    profiler's raw events.  Device time comes from the device-side events
    alone (kernels, memcpy, memset): the aten ops' own device times are
    these same kernels.  A name's ms sum its events; the device ms are the
    union of all their intervals, so kernels that overlap (programmatic
    dependent launches) count once.  ``exclude`` names ranges whose
    device-side twins are not kernels."""
    launches = sum(1 for e in events if e.name in LAUNCH_CALLS)
    kernels: dict[str, list] = {}
    spans = []
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in exclude:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us() / 1e3
            k[1] += 1
            spans.append((e.time_range.start, e.time_range.end))
    return launches, kernels, union_ms(spans)


def port_records(snap, ticks: int, admitted: int) -> dict:
    """The port's records of a window of ``ticks`` ticks
    (``trace.snapshot()``) and the containers it ``admitted``: device
    read-backs per tick by site, admit-round host ms per candidate (its
    ``host_sync`` child left out) and the share of candidates admitted;
    None where the window tried no candidate."""
    cands = snap.totals.get("candidates", 0)
    admit_ns, _ = trace.self_ns(snap, "admit_round")
    return {"syncs_per_tick": {k: n / ticks for k, n in
                               trace.syncs_by_site(snap).items()},
            "admit_ms_per_candidate": (admit_ns / 1e6 / cands if cands
                                       else None),
            "admitted_share": admitted / cands if cands else None}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=2000)
    ap.add_argument("--containers", type=int, default=6000)
    ap.add_argument("--policy", default="netaware")
    ap.add_argument("--delay-mode", default="fw", choices=["path", "fw"])
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    C = args.containers
    cfg = SimConfig(n_jobs=max(10, C // 3), n_tasks=C, n_containers=C,
                    horizon=args.warmup + args.ticks,
                    delay_mode=args.delay_mode)
    spec, sim0, params = build_once(cfg, n_hosts=args.hosts,
                                    device=args.device)
    device = sim0.t.device
    on_cuda = device.type == "cuda"
    if on_cuda:
        torch.use_deterministic_algorithms(True)   # as run_sim does
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    policy = get_policy(args.policy, device=device)
    tick = make_tick(cfg, policy, params, spec.n_hosts, spec.n_nodes)
    sim = sim0._replace(net=network.apply_link_params(
        sim0.net, params.bw_mbps, params.loss))
    for tt in range(args.warmup):
        sim, _ = tick(sim, tt)
    sync()

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda
                                     else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        decided = []
        for tt in range(args.warmup, args.warmup + args.ticks):
            sim, m = tick(sim, tt)
            decided.append(m.decisions)
        sync()
        wall = time.perf_counter() - t0

    events = prof.events()
    # the phase ranges from the raw events: with CUDA activity on, a
    # range's device-side twin shares its key in key_averages()
    phase_us = dict.fromkeys(PHASES, 0.0)
    for e in events:
        if e.name in phase_us and e.device_type == DeviceType.CPU:
            phase_us[e.name] += e.cpu_time_total
    phases = {p: round(us / 1e3 / args.ticks, 3)
              for p, us in phase_us.items()}
    launches, kernels, device_ms = device_summary(events, exclude=PHASES)
    top = sorted(((n, ms, c) for n, (ms, c) in kernels.items()),
                 key=lambda r: -r[1])[:12]
    ops = sorted(((e.key, _device_us(e, True) / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.key.startswith("aten::")), key=lambda r: -r[1])[:8]
    busy = device_ms / (wall * 1e3) if device_ms > 0 else None
    port = port_records(trace.snapshot(), args.ticks,
                        int(torch.stack(decided).sum()))

    print(f"{args.hosts} hosts / {C} containers, {args.delay_mode}, "
          f"{args.policy}: ticks {args.warmup}..{args.warmup + args.ticks}"
          f" in {wall:.4f} s = {args.ticks / wall:.4f} ticks/s")
    print("host ms per tick by phase: "
          + ", ".join(f"{k} {v}" for k, v in phases.items()))
    print(f"kernel launches per tick: {launches / args.ticks:.1f}")
    print("device busy share: " + (f"{busy:.4f} ({device_ms:.3f} ms of "
                                   f"kernel time in {wall * 1e3:.1f} ms)"
                                   if busy is not None else "not measured"))
    print("device time by kernel:")
    for name, ms, count in top:
        print(f"  {ms:10.3f} ms  {count:7d}x  {name[:90]}")
    print("device time by aten op (the kernels it launched):")
    for name, ms, count in ops:
        print(f"  {ms:10.3f} ms  {count:7d}x  {name}")
    print("device read-backs per tick by site: "
          + (", ".join(f"{k} {v:.2f}" for k, v in
                       sorted(port["syncs_per_tick"].items())) or "none"))
    print(f"admit round: {port['admit_ms_per_candidate']} host ms per "
          f"candidate, admitted share {port['admitted_share']}")
    print(json.dumps({
        "hosts": args.hosts, "containers": C, "policy": args.policy,
        "delay_mode": args.delay_mode, "ticks": args.ticks,
        "wall_s": wall, "ticks_per_s": args.ticks / wall,
        "host_ms_per_tick": phases,
        "launches_per_tick": launches / args.ticks,
        "device_ms": device_ms if device_ms > 0 else None,
        "device_busy_share": busy,
        "device": (torch.cuda.get_device_name(device) if on_cuda else "cpu"),
        "top_kernels": [{"name": n, "ms": ms, "count": c}
                        for n, ms, c in top],
        "top_aten_ops": [{"name": n, "ms": ms, "count": c}
                         for n, ms, c in ops],
        "port": port}))


if __name__ == "__main__":
    main()
