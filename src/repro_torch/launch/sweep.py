"""Sweep driver: the policy x scenario x seed grid on one device.

Counterpart of ``repro.launch.sweep``.  The grid is one flattened axis of
P*S*N cells in the JAX package's order (cell ``b`` is policy
``b // (S*N)``, scenario ``(b // N) % S``, seed ``b % N``).  The JAX
sweep runs it as one ``jit(vmap)``; the port's tick reads its admit and
migration loop lengths back from the device, so here every cell goes
through the port's own single-cell ``engine.simulate`` (stacked) or
``engine.stream_chunks`` (streamed), one after another.  A cell is then
its standalone ``run_sim`` bit for bit, by construction:

    policies [P] --+
    scenarios [S] --+--> flatten [P*S*N] --> one cell at a time --> [P, S, N]
    seeds     [N] --+

    PYTHONPATH=src python -m repro_torch.launch.sweep --policies all \\
        --seeds 2 --horizon 120 --table avg_runtime --out sweep.json
    PYTHONPATH=src python -m repro_torch.launch.sweep --device cpu \\
        --hosts 20 --horizon 10 --chunk 4 --slab 5
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import (SimConfig, get_policy, list_policies,
                              sweep_summaries, sweep_table)
from repro_torch.core import stats
from repro_torch.core.engine import (run_sim_chunked, simulate,
                                     stream_chunks, use_deterministic)
from repro_torch.core.report import json_clean
from repro_torch.core.scenario import (ScenarioSpec, build_scenarios,
                                       default_scenarios, stack_tree)
from repro_torch.core.scheduling import validate_weights
from repro_torch.core.types import (ExecPlan, OnlineSummary, PolicyParams,
                                    RunParams, SimState, SummaryAcc,
                                    TickMetrics, check_devices, device_name,
                                    resolve_device, tree_map)
from repro_torch.kernels import resolve_kernel
from repro_torch.launch.execargs import add_exec_args

# SimState leaves that are TOPOLOGY, not state: identical across every
# cell of one grid by construction (build_scenarios builds one network and
# every host mix assigns leaves as arange % n_leaf).  A streamed slab
# brings them back to the host once, not once per cell.
STATIC_TOPOLOGY_LEAVES = frozenset({
    ("hosts", "leaf"),
    ("net", "link_u"), ("net", "link_v"),
    ("net", "path_links"), ("net", "path_nlinks"),
})


def tree_leaves_with_path(tree, path: tuple = ()) -> list:
    """[(field-name path, leaf)] of a tree of (nested) NamedTuples, in
    field order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [item for name, x in zip(tree._fields, tree)
                for item in tree_leaves_with_path(x, path + (name,))]
    return [(path, tree)]


def tree_unflatten(template, leaves):
    """``template``'s structure with ``leaves`` in field order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def _is_static_leaf(path: tuple) -> bool:
    return any(path[-len(s):] == s for s in STATIC_TOPOLOGY_LEAVES)


def _static_indices(sims: SimState) -> set:
    """Positions of the topology leaves among the state's leaves."""
    return {i for i, (p, _) in enumerate(tree_leaves_with_path(sims))
            if _is_static_leaf(p)}


def _check_topology_uniform(sims: SimState) -> None:
    """Every cell of one grid must share the network topology."""
    for path, x in tree_leaves_with_path(sims):
        if _is_static_leaf(path):
            ref = x.reshape((-1,) + tuple(x.shape[2:]))[0]
            if not torch.equal(x, ref.expand_as(x)):
                raise ValueError(
                    f"sweep cells disagree on topology leaf "
                    f"{'.'.join(path)!r}; all scenarios of one grid must "
                    f"share the network topology (build_scenarios builds "
                    f"exactly one)")


def stack_policies(names_or_params: Sequence, device=None) -> PolicyParams:
    """[P]-stacked PolicyParams from registered names (or ready-made
    ``PolicyParams``) on ``device``; every vector is checked against the
    canonical weight length first."""
    pols = [p if isinstance(p, PolicyParams)
            else get_policy(p, device=device) for p in names_or_params]
    for i, p in enumerate(pols):
        validate_weights(p.weights, f"stack_policies entry {i}: ")
    return PolicyParams(weights=torch.stack([p.weights for p in pols]))


def _grid_shape(sims: SimState, pols: PolicyParams):
    P = pols.weights.shape[0]
    S, N = sims.t.shape
    return P, S, N, P * S * N


def _cell(sims: SimState, pols: PolicyParams, rps: RunParams, b: int,
          S: int, N: int):
    """The inputs of flattened cell ``b``: (SimState, PolicyParams,
    RunParams), views of the stacked grid."""
    p, s, n = b // (S * N), (b // N) % S, b % N
    return (tree_map(lambda x: x[s, n], sims),
            PolicyParams(weights=pols.weights[p]),
            tree_map(lambda x: x[s], rps))


def make_grad_fn(*args, **kwargs):
    """The differentiated sweep comes with the autodiff slice."""
    raise NotImplementedError(
        "make_grad_fn is not ported yet: it comes with the autodiff slice "
        "of repro_torch")


def make_sweep_fn(cfg: SimConfig, n_hosts: int, n_nodes: int, horizon: int,
                  devices=None):
    """The stacked sweep: ``fn(sims [S, N], pols [P], params [S]) ->
    (finals, metrics)`` with [P, S, N] leading axes (tensors on the grid's
    device; metrics [P, S, N, T]).  Each cell is ``engine.simulate``, the
    function standalone ``run_sim`` runs, so each is that run bit for
    bit."""
    check_devices(devices)

    def fn(sims, pols, rps):
        _check_topology_uniform(sims)
        use_deterministic(sims.t.device)
        P, S, N, B = _grid_shape(sims, pols)
        finals, metrics = [], []
        for b in range(B):
            sim, pol, rp = _cell(sims, pols, rps, b, S, N)
            f, m = simulate(sim, cfg, pol, n_hosts, n_nodes, horizon, rp)
            finals.append(f)
            metrics.append(m)
        grid = lambda x: x.reshape((P, S, N) + tuple(x.shape[1:]))
        return (tree_map(grid, stack_tree(finals)),
                tree_map(grid, stack_tree(metrics)))

    fn.n_devices = 1
    return fn


_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32}


def to_host(tensors) -> list:
    """``tensors`` as numpy arrays, packed into one byte buffer on their
    device and copied to the host once."""
    specs = [(t.dtype, tuple(t.shape)) for t in tensors]
    buf = torch.cat([t.reshape(-1).view(torch.uint8)
                     for t in tensors]).cpu().numpy()
    out, off = [], 0
    for dtype, shape in specs:
        dt = np.dtype(_NP_DTYPES[dtype])
        size = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        out.append(buf[off:off + size].view(dt).reshape(shape).copy())
        off += size
    return out


def make_stream_fn(cfg: SimConfig, n_hosts: int, n_nodes: int, horizon: int,
                   chunk: int, slab: int | None = None, devices=None,
                   overlap: bool = True):
    """The streamed sweep: the same [P, S, N] grid as ``make_sweep_fn``,
    each cell run in chunks of ``chunk`` ticks (``engine.stream_chunks``,
    the accumulator reset every chunk), iterated in SLABS of ``slab``
    cells.  A slab's finals and per-chunk accumulators come to the host in
    ONE copy (:func:`to_host`), so the device holds one slab of final
    states at a time.

    Returns ``fn(sims, pols, rps) -> (finals, summary)``: finals as host
    numpy with [P, S, N] leading axes (bit for bit the stacked sweep's)
    and a [P, S, N] ``OnlineSummary``.

    ``overlap`` is taken for the JAX package's signature; the port copies
    each slab synchronously whatever it says (no run on the card has shown
    a copy left in flight gaining time).

    ``fn.iter_slabs(sims, pols, rps, slab_starts)`` is the runner itself,
    a generator of ``(s0, finals_leaves, slab_summary)`` per start offset:
    each start owns cells ``s0 .. min(s0 + Bs, B) - 1``, so the last slab
    may be short; ``fn.slab_cells(B)`` is ``Bs``.
    """
    stats.check_chunk(chunk, cfg.n_containers)
    check_devices(devices)

    def slab_cells(B: int) -> int:
        return B if slab is None else min(slab, B)

    def run_cell(sim, pol, rp):
        accs = []
        sim = stream_chunks(sim, cfg, pol, n_hosts, n_nodes, horizon, chunk,
                            rp, accs.append)
        return sim, accs

    def iter_slabs(sims, pols, rps, slab_starts):
        _check_topology_uniform(sims)
        use_deterministic(sims.t.device)
        P, S, N, B = _grid_shape(sims, pols)
        Bs = slab_cells(B)
        statics = _static_indices(sims)
        n_fields = len(SummaryAcc._fields)
        for s0 in slab_starts:
            finals, accs = [], []
            for b in range(s0, min(s0 + Bs, B)):
                f, a = run_cell(*_cell(sims, pols, rps, b, S, N))
                finals.append([x for _, x in tree_leaves_with_path(f)])
                accs.append(a)
            leaves = [finals[0][i] if i in statics
                      else torch.stack([f[i] for f in finals])
                      for i in range(len(finals[0]))]
            by_chunk = [x for c in range(len(accs[0]))
                        for x in stack_tree([a[c] for a in accs])]
            host = to_host(leaves + by_chunk)
            slab_sum = stats.online_init((len(finals),))
            for c0 in range(len(leaves), len(host), n_fields):
                slab_sum = stats.online_fold(
                    slab_sum, SummaryAcc(*host[c0:c0 + n_fields]))
            yield s0, host[:len(leaves)], slab_sum

    def fn(sims, pols, rps):
        P, S, N, B = _grid_shape(sims, pols)
        statics = _static_indices(sims)
        slabs = [out for _, *out in iter_slabs(
            sims, pols, rps, range(0, B, slab_cells(B)))]
        leaves = [
            np.broadcast_to(x, (P, S, N) + x.shape).copy()
            if i in statics                      # restore the batched shape
            else np.concatenate([h[i] for h, _ in slabs]).reshape(
                (P, S, N) + x.shape[1:])
            for i, x in enumerate(slabs[0][0])]
        summary = OnlineSummary(*(np.concatenate(xs).reshape((P, S, N))
                                  for xs in zip(*(s for _, s in slabs))))
        return tree_unflatten(sims, leaves), summary

    fn.n_devices = 1
    fn.iter_slabs = iter_slabs
    fn.slab_cells = slab_cells
    return fn


@dataclasses.dataclass
class SweepResult:
    """A sweep's grid and results.  ``compile_cache_misses`` is 0 in the
    port: nothing is compiled (the JAX sweep counts its jit cache misses
    here).  ``n_devices`` is 1."""

    policies: list[str]
    scenarios: list[ScenarioSpec]
    seeds: tuple[int, ...]
    finals: SimState          # [P, S, N, ...]
    metrics: TickMetrics | None   # [P, S, N, T]; None when streamed
    wall_s: float
    compile_cache_misses: int = 0
    n_devices: int = 1
    summary: OnlineSummary | None = None  # [P, S, N] streamed fold
    _rows: list | None = dataclasses.field(default=None, repr=False)

    def summaries(self) -> list[dict[str, Any]]:
        if self._rows is None:  # per-cell summarize is host-side O(cells)
            self._rows = sweep_summaries(
                self.finals,
                self.metrics if self.metrics is not None else self.summary,
                self.policies, [s.name for s in self.scenarios], self.seeds)
        return self._rows

    def table(self, value: str = "avg_runtime") -> str:
        return sweep_table(self.summaries(), value=value)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sweep(policies: Sequence[str] | None = None,
              scenarios: Sequence[ScenarioSpec] | None = None,
              seeds: Sequence[int] = (0,), cfg: SimConfig | None = None,
              n_hosts: int = 20, n_spine: int = 2, n_leaf: int = 4,
              plan: ExecPlan | None = None, device=None) -> SweepResult:
    """Build the grid on ``device`` (default ``cuda``) and run it.

    ``plan.chunk`` switches to the streamed sweep (``make_stream_fn``):
    [P, S, N] summaries without [P, S, N, T] metrics, the grid gathered
    ``plan.slab`` cells at a time.  Cell results are bit-identical either
    way.  The plan's kernel selectors fold into ``cfg``."""
    policies = list(policies if policies is not None else list_policies())
    scenarios = list(scenarios if scenarios is not None
                     else default_scenarios())
    plan = ExecPlan() if plan is None else plan
    cfg = plan.apply_to_config(cfg or SimConfig())
    device = resolve_device(device)
    net_spec, sims, rps = build_scenarios(scenarios, cfg, n_hosts=n_hosts,
                                          n_spine=n_spine, n_leaf=n_leaf,
                                          seeds=seeds, device=device)
    pol = stack_policies(policies, device=device)
    common = dict(policies=policies, scenarios=scenarios, seeds=tuple(seeds))
    if plan.chunk is not None:
        fn = make_stream_fn(cfg, net_spec.n_hosts, net_spec.n_nodes,
                            cfg.horizon, chunk=plan.chunk, slab=plan.slab,
                            devices=plan.devices, overlap=plan.overlap)
        t0 = time.time()
        finals, summary = fn(sims, pol, rps)
        return SweepResult(finals=finals, metrics=None, summary=summary,
                           wall_s=round(time.time() - t0, 2), **common)
    fn = make_sweep_fn(cfg, net_spec.n_hosts, net_spec.n_nodes, cfg.horizon,
                       devices=plan.devices)
    t0 = time.time()
    finals, metrics = fn(sims, pol, rps)
    _synchronize(device)
    return SweepResult(finals=finals, metrics=metrics,
                       wall_s=round(time.time() - t0, 2), **common)


def run_sim_vmapped(sims: SimState, cfg: SimConfig, policy: PolicyParams,
                    n_hosts: int, n_nodes: int, horizon: int,
                    params: RunParams | None = None,
                    chunk: int | None = None):
    """Seed-batched single-policy run (a leading [N] axis on every SimState
    leaf), the degenerate 1 x 1 x N sweep: (finals [N, ...], metrics
    [N, T]), or with ``chunk`` (finals [N, ...], [N] ``OnlineSummary``).
    Each seed is its standalone run."""
    device = sims.t.device
    params = cfg.run_params(device) if params is None else params
    cells = [tree_map(lambda x: x[i], sims) for i in range(sims.t.shape[0])]
    if chunk is None:
        use_deterministic(device)
        outs = [simulate(c, cfg, policy, n_hosts, n_nodes, horizon, params)
                for c in cells]
        return (stack_tree([f for f, _ in outs]),
                stack_tree([m for _, m in outs]))
    outs = [run_sim_chunked(c, cfg, policy, n_hosts, n_nodes, horizon, chunk,
                            params=params) for c in cells]
    return (stack_tree([f for f, _ in outs]),
            OnlineSummary(*(np.stack(xs)
                            for xs in zip(*(o for _, o in outs)))))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policies", default="all",
                    help=f"comma-separated subset of {list_policies()} "
                         "or 'all'")
    ap.add_argument("--seeds", type=int, default=1,
                    help="number of seeds (0..n-1) per cell")
    ap.add_argument("--horizon", type=int, default=120)
    ap.add_argument("--hosts", type=int, default=20)
    ap.add_argument("--table", default="avg_runtime",
                    help="summary metric for the grouped table")
    ap.add_argument("--out", default=None,
                    help="write per-cell summary rows as JSON")
    ap.add_argument("--delay-mode", default="path", choices=["path", "fw"],
                    help="delay refresh: ECMP path sum or full APSP "
                         "(the fw_minplus kernel)")
    add_exec_args(ap)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    return ap


def kernel_note(cfg: SimConfig, device) -> str:
    """Which kernel each hot path resolves to on ``device``."""
    how = lambda flag: "kernel" if resolve_kernel(flag, device) else "plain"
    return (f"delay={cfg.delay_mode}/{cfg.delay_kernel}"
            f"(-> {how(cfg.delay_kernel)}), "
            f"waterfill={cfg.waterfill_kernel}"
            f"(-> {how(cfg.waterfill_kernel)})")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    policies = (list_policies() if args.policies == "all"
                else args.policies.split(","))
    plan = ExecPlan.from_args(args)
    cfg = plan.apply_to_config(SimConfig(horizon=args.horizon,
                                         delay_mode=args.delay_mode))
    device = resolve_device(args.device)
    n_leaf = max(4, args.hosts // 5)
    res = run_sweep(policies=policies, seeds=range(args.seeds), cfg=cfg,
                    n_hosts=args.hosts, n_spine=max(2, n_leaf // 4),
                    n_leaf=n_leaf, plan=plan, device=device)
    cells = len(res.policies) * len(res.scenarios) * len(res.seeds)
    print(f"# {cells} cells ({len(res.policies)} policies x "
          f"{len(res.scenarios)} scenarios x {len(res.seeds)} seeds) in "
          f"{res.wall_s}s, device={device_name(device)}, "
          f"{kernel_note(cfg, device)}")
    print(res.table(args.table))
    if args.out:
        rows = res.summaries()
        for row in rows:   # self-describing rows: device + kernel dispatch
            row["backend"] = "torch-" + device.type
            row["device"] = device_name(device)
            row["delay_mode"] = args.delay_mode
            row["delay_kernel"] = cfg.delay_kernel
            row["waterfill_kernel"] = cfg.waterfill_kernel
        with open(args.out, "w") as f:
            json.dump(json_clean(rows), f, indent=1)
        print(f"# wrote {args.out}")


if __name__ == "__main__":
    main()
