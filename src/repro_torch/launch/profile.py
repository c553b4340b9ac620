"""Where a tick's time goes: profile a steady window of ticks on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile \\
        --hosts 2000 --containers 6000 --delay-mode fw --policy netaware

Runs ``--warmup`` ticks, then ``--ticks`` ticks under ``torch.profiler``
(CPU and CUDA activity), and prints: the window's wall time and ticks/s
(host clock after a synchronize), the host time of each labelled tick phase
(``engine.make_tick_ext``), the kernel launches per tick, the device's busy
share (summed device-side event time over wall time, "not measured" when
the profiler sees no device activity), and the kernels and aten ops with
the most device time.  The profiler slows the host, so the window's
ticks/s is lower than an unprofiled run's.  The last
line is the same as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import SimConfig, get_policy, network
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


def device_summary(events, exclude=()):
    """(kernel launches, {device event name: [ms, count]}, device ms) of a
    profiler's raw events.  Device time comes from the device-side events
    alone (kernels, memcpy, memset): the aten ops' own device times are
    these same kernels.  ``exclude`` names ranges whose device-side twins
    are not kernels."""
    launches = sum(1 for e in events if e.name in LAUNCH_CALLS)
    kernels: dict[str, list] = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in exclude:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us() / 1e3
            k[1] += 1
    return launches, kernels, sum(ms for ms, _ in kernels.values())


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
        for tt in range(args.warmup, args.warmup + args.ticks):
            sim, _ = tick(sim, tt)
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
                         for n, ms, c in ops]}))


if __name__ == "__main__":
    main()
