"""On-card smoke test of the PyTorch port (repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script when it fails:
  1. build both CUDA kernels from src/repro_torch/kernels/csrc/ (one nvcc
     per source, started together);
  2. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes and at an edge shape, and time both (CUDA
     events, median of 20 launches after warm-up);
  3. the paper experiment: the six policies at 20 hosts / 300 containers,
     horizon 120, kernels 'auto', each completing 300/300 and agreeing
     with the port's CPU run (plain versions) leaf by leaf;
  4. the main path at real size: 2000 hosts / 6000 containers, 'fw'
     delay refresh, policy netaware, horizon 40 — launch counts reset just
     before and read just after, ticks/s and peak device memory printed;
     then the same run again, whose final state must be bit-identical.
The last lines are the card's name and power limit, one JSON line of
kernel measurements, and the result line.  Imports torch and repro_torch
only.  Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device available", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import (SimConfig, build_paper_hosts,  # noqa: E402
                              build_paper_network, get_policy, init_sim,
                              list_policies, paper_workload, run_sim,
                              scaled_hosts, summarize)
from repro_torch.core.convert import assert_state_close  # noqa: E402
from repro_torch.kernels import (LAUNCHES, _build,  # noqa: E402
                                 reset_launch_counts)
from repro_torch.kernels.fw_minplus import (floyd_warshall,  # noqa: E402
                                            floyd_warshall_ref)
from repro_torch.kernels.seg_waterfill import (seg_waterfill,  # noqa: E402
                                               seg_waterfill_ref)

DEV = torch.device("cuda")
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and the FP32
# rate outside the tensor cores, the type both kernels compute in
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
REPS = 20


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=REPS, warm=3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2 inputs
# ---------------------------------------------------------------------------
def main_path_flows(net, n_hosts, F, seed):
    """F flows between random hosts of the real-size fabric, routed on its
    ECMP paths as network.flow_rates routes them (inactive flows -1)."""
    r = np.random.default_rng(seed)
    src = torch.tensor(r.integers(0, n_hosts, F), device=DEV)
    dst = torch.tensor(r.integers(0, n_hosts, F), device=DEV)
    active = torch.tensor(r.uniform(size=F) < 0.8, device=DEV)
    links = torch.where(active[:, None], net.path_links[src, dst], -1)
    tcp = torch.where(torch.tensor(r.uniform(size=F) < 0.3, device=DEV),
                      torch.tensor(r.uniform(10, 1e4, F), dtype=torch.float32,
                                   device=DEV), 1e9).float()
    return links.int().contiguous(), active, net.link_bw_kbps, tcp


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


def check_kernels(real_net, n_hosts):
    rows = {}
    # seg_waterfill: rates bit for bit, load within rtol 2e-6
    F, E = 12000, real_net.link_bw_kbps.shape[0]
    main = main_path_flows(real_net, n_hosts, F, seed=1)
    errs = []
    for name, args in ((f"F={F},E={E}", main),
                       ("F=8,E=5", random_flows(8, 5, seed=2))):
        rk, lk = seg_waterfill(*args)
        rr, lr = seg_waterfill_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(rk, rr):
            raise AssertionError(f"seg_waterfill {name}: rates differ, max "
                                 f"{(rk - rr).abs().max().item()}")
        torch.testing.assert_close(lk, lr, rtol=2e-6, atol=1e-3)
        errs.append(max((rk - rr).abs().max().item(),
                        (lk - lr).abs().max().item()))
        log(f"seg_waterfill {name}: rates bit-exact, load within rtol 2e-6")
    ms = time_ms(lambda: seg_waterfill(*main))
    plain = time_ms(lambda: seg_waterfill_ref(*main))
    links, active, bw, tcp = main
    n_bytes = 4 * (links.numel() + F + E + F) + 4 * (F + E)
    b, by = bound_ms(n_bytes, waterfill_ops(links, active, E))
    log(f"seg_waterfill F={F} E={E}: kernel {ms:.4f} ms, plain {plain:.4f} ms,"
        f" bound {b:.6f} ms ({by})")
    rows["seg_waterfill"] = dict(
        name="seg_waterfill", route="cuda",
        source="src/repro_torch/kernels/csrc/seg_waterfill.cu",
        replaces="src/repro/kernels/seg_waterfill/seg_waterfill.py:190",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b,
        bound_by=by, library_ms=None)

    # fw_minplus: bit-exact on dyadic weights, rtol 1e-5 otherwise
    n = 2402
    errs = []
    for name, A, exact in (("n=2402 dyadic", adjacency(n, 3, True), True),
                           ("n=2402 random", adjacency(n, 4, False), False),
                           ("n=37 dyadic", adjacency(37, 5, True), True)):
        Dk, Dr = floyd_warshall(A), floyd_warshall_ref(A)
        torch.cuda.synchronize()
        if exact and not torch.equal(Dk, Dr):
            raise AssertionError(f"fw_minplus {name}: not bit-exact, max "
                                 f"{(Dk - Dr).abs().max().item()}")
        torch.testing.assert_close(Dk, Dr, rtol=1e-5, atol=1e-4)
        errs.append((Dk - Dr).abs().max().item())
        log(f"fw_minplus {name}: {'bit-exact' if exact else 'within rtol 1e-5'}")
    A = adjacency(n, 4, False)
    ms = time_ms(lambda: floyd_warshall(A))
    plain = time_ms(lambda: floyd_warshall_ref(A))
    b, by = bound_ms(2 * 4 * n * n, 2.0 * n ** 3)
    log(f"fw_minplus n={n}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {b:.6f} ms ({by})")
    rows["fw_minplus"] = dict(
        name="fw_minplus", route="cuda",
        source="src/repro_torch/kernels/csrc/fw_minplus.cu",
        replaces="src/repro/kernels/fw_minplus/fw_minplus.py:100",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b,
        bound_by=by, library_ms=None)
    return rows


# ---------------------------------------------------------------------------
# Phases 3 and 4
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
        final, metrics = run_sim(sim0, cfg, get_policy(policy, device=DEV),
                                 spec.n_hosts, spec.n_nodes, cfg.horizon)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        rep = summarize(final, metrics)
        want_fw = cfg.horizon // cfg.delay_update_interval if mode == "fw" \
            else 0
        if counts != {"seg_waterfill": cfg.horizon, "fw_minplus": want_fw}:
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
            f"{rep['total_cost']:.1f}, launches {counts}, matches the CPU run")


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

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    final, metrics, wall = once()
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if counts["seg_waterfill"] != horizon or counts["fw_minplus"] < 1:
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
    return counts


def _leaves(t, prefix=""):
    out = {}
    for k, v in t._asdict().items():
        if isinstance(v, tuple):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def main():
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.time()
    _build.build()
    log(f"built kernels {list(_build.SOURCES)} in {time.time() - t0:.2f} s")

    torch.use_deterministic_algorithms(True)
    cfg = SimConfig()
    _, real_net = build_paper_network(cfg, n_hosts=2000, n_leaf=400,
                                      device=DEV)
    rows = check_kernels(real_net, 2000)
    paper_experiment()
    counts = real_size_run()
    for name, row in rows.items():
        row["launches"] = counts[name]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(json.dumps({"kernels": [rows["seg_waterfill"], rows["fw_minplus"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
