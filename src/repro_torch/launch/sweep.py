"""Sweep driver: the policy x scenario x seed grid on one device or cut
over several.

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

With ``devices`` (:func:`~repro_torch.core.types.resolve_devices`) the
flattened axis is padded to a multiple of the device count and cut into
contiguous shards, as the JAX package's ``grid`` mesh axis cuts it; shard
``j``'s cells run on ``devices[j]``.  Pad cells are not run (the JAX
package computes them only to drop them).  The shards run one after
another: they do not overlap in time.

``make_grad_fn`` differentiates the same grid's soft-placement surrogate
in the policy weights with torch autograd.

    PYTHONPATH=src python -m repro_torch.launch.sweep --policies all \\
        --seeds 2 --horizon 120 --table avg_runtime --out sweep.json
    PYTHONPATH=src python -m repro_torch.launch.sweep --device cpu \\
        --hosts 20 --horizon 10 --chunk 4 --slab 5
    PYTHONPATH=src python -m repro_torch.launch.sweep --device cpu \\
        --policies firstfit,netaware --horizon 60 --chunk 16 --telescope
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import json
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import (SimConfig, get_policy, list_policies,
                              sweep_summaries, sweep_table)
from repro_torch.core import stats, trace
from repro_torch.core.engine import (run_sim, simulate, simulate_chunk,
                                     stream_chunks, use_deterministic)
from repro_torch.core.report import json_clean
from repro_torch.core.scenario import (ScenarioSpec, build_scenarios,
                                       default_scenarios, stack_tree)
from repro_torch.core.scheduling import validate_weights
from repro_torch.core.types import (ExecPlan, OnlineSummary, PolicyParams,
                                    RunParams, SimState, SummaryAcc,
                                    TickMetrics, device_name, resolve_device,
                                    resolve_devices, tree_map)
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
          S: int, N: int, device):
    """The inputs of flattened cell ``b`` on ``device``: (SimState,
    PolicyParams, RunParams), views of the stacked grid where it is
    there already."""
    p, s, n = b // (S * N), (b // N) % S, b % N
    return _on(device, (tree_map(lambda x: x[s, n], sims),
                        PolicyParams(weights=pols.weights[p]),
                        tree_map(lambda x: x[s], rps)))


def _shards(s0: int, n_cells: int, real: int, k: int) -> list:
    """The ``k`` contiguous shards of the ``n_cells``-cell block starting
    at cell ``s0``, padded to a multiple of ``k``, each cut to the block's
    first ``real`` cells: pad cells are dropped, so a trailing shard may
    be short or empty."""
    per = -(-n_cells // k)
    return [range(s0 + j * per, s0 + min((j + 1) * per, real))
            for j in range(k)]


def _on(device, tree):
    """``tree``'s tensors on ``device`` (the same tensors where they
    already are); a plain tuple is a tuple of trees."""
    if type(tree) is tuple:
        return tuple(_on(device, t) for t in tree)
    return tree_map(lambda x: x.to(device), tree)


def _grid_cells(sims: SimState, pols: PolicyParams, rps: RunParams, devs,
                starts=(0,), width: int | None = None):
    """The grid's cells in the order they run, as ``(b, device, inputs)``,
    ``inputs()`` the cell's ``(sim, pol, rp)`` on its device: for each
    start ``s0`` the block of ``width`` cells from it (default the whole
    grid), cut into contiguous shards, shard ``j`` on ``devs[j]`` (or the
    grid's own device without ``devs``; module docstring).  ``starts`` is
    read lazily.  Before the first cell, checks that every cell shares the
    topology and turns on deterministic mode on each device."""
    _check_topology_uniform(sims)
    targets = devs or (sims.t.device,)
    for d in targets:
        use_deterministic(d)
    P, S, N, B = _grid_shape(sims, pols)
    width = B if width is None else width
    for s0 in starts:
        shards = _shards(s0, width, min(width, B - s0), len(targets))
        for dev, cells in zip(targets, shards):
            for b in cells:
                yield b, dev, functools.partial(_cell, sims, pols, rps, b,
                                                S, N, dev)


def _grad_of(value: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """d value / d w, zeros where the value does not depend on ``w`` (a
    cell that made no soft decision)."""
    if not value.requires_grad:
        return torch.zeros_like(w)
    g, = torch.autograd.grad(value, w, allow_unused=True)
    return torch.zeros_like(w) if g is None else g


def make_grad_fn(cfg: SimConfig, n_hosts: int, n_nodes: int, horizon: int,
                 objective: str = "soft_blend", chunk: int | None = None,
                 devices=None):
    """The differentiated sweep: ``fn(sims, pols, rps) -> (obj [P],
    grad [P, NUM_POLICY_WEIGHTS])``, the per-policy mean over the [S, N]
    scenario/seed cells of the surrogate objective
    (``stats.soft_objective``) and its gradient in
    ``PolicyParams.weights``, by torch autograd.

    Requires ``cfg.soft_placement``.  The dynamics stay the hard argmin,
    so gradients flow through the per-decision score rows; the one
    continuous path through the state is the periodic delay refresh,
    which bakes ``weights[util]``/``weights[cross_leaf]`` into
    ``net.comm_cost``.  Cells run one after another through the
    single-cell engine, each on a leaf copy of its policy's weights.

    ``chunk=None`` runs each cell's whole horizon and differentiates its
    objective, the cells cut over ``devices`` as ``make_sweep_fn`` cuts
    them (values and gradients gathered to the first).  A ``chunk``
    streams it: the state's leaves are detached at every chunk boundary,
    each chunk's numerator (from a fresh ``SummaryAcc``) is differentiated
    and its gradient added to an f64 host total, the chunk folded into
    the ``OnlineSummary``, and at the end the totals are divided by the
    final count (piecewise constant in the weights), so one chunk's graph
    is freed before the next runs.
    Values equal the stacked ones at any chunk size; gradients too, except
    the ``util``/``cross_leaf`` components when a boundary falls while
    decisions are still being made (truncated back-propagation through
    ``comm_cost``, as in the JAX package).  The chunked gradient runs
    unsharded on the grid's device (``fn.n_devices == 1``), as in the JAX
    package.  The CUDA kernels run forward only: none of their inputs
    depends on the weights.
    """
    if not cfg.soft_placement:
        raise ValueError(
            "make_grad_fn requires cfg.soft_placement=True — with it off "
            "the surrogate sums are constant 0.0 and every gradient "
            "vanishes identically")
    if objective not in stats.SOFT_OBJECTIVES:
        raise KeyError(f"unknown soft objective {objective!r}; known: "
                       f"{list(stats.SOFT_OBJECTIVES)}")
    devs = resolve_devices(devices)
    if chunk is not None:
        stats.check_chunk(chunk, cfg.n_containers)
        devs = None
    n_dev = 1 if devs is None else len(devs)

    def stacked_cell(sim, w, rp):
        _, metrics = simulate(sim, cfg, PolicyParams(weights=w), n_hosts,
                              n_nodes, horizon, rp)
        value = stats.soft_objective(metrics, objective)
        return value.detach(), _grad_of(value, w)

    def chunked_cell(sim, w, rp):
        pol = PolicyParams(weights=w)
        online = stats.online_init()
        gnum = np.zeros(w.shape, np.float64)
        for t0 in range(0, horizon, chunk):
            sim = tree_map(torch.Tensor.detach, sim)
            sim, acc = simulate_chunk(sim, stats.acc_init(w.device), t0, cfg,
                                      pol, n_hosts, n_nodes,
                                      min(chunk, horizon - t0), rp)
            num, _ = stats.soft_num_den(acc, objective)
            gnum += _grad_of(num, w).double().cpu().numpy()
            online = stats.online_fold(online, acc)
        num, den = stats.soft_num_den(online, objective)
        den = max(float(den), 1.0)
        return torch.tensor(num / den), torch.tensor(gnum / den)

    cell_fn = stacked_cell if chunk is None else chunked_cell

    def fn(sims, pols, rps):
        home = devs[0] if devs else sims.t.device
        P, S, N, B = _grid_shape(sims, pols)
        vals, grads = [], []
        with torch.enable_grad():
            for _, _, cell in _grid_cells(sims, pols, rps, devs):
                sim, pol, rp = cell()
                w = pol.weights.detach().clone().requires_grad_()
                v, g = cell_fn(sim, w, rp)
                vals.append(v.to(home, torch.float64))
                grads.append(g.to(home, torch.float64))
        # the mean over a policy's cells, in f64 (the chunked path's
        # totals are f64 already)
        mean = lambda xs: (torch.stack(xs).reshape((P, S * N)
                                                   + tuple(xs[0].shape))
                           .mean(1).to(torch.float32))
        return mean(vals), mean(grads)

    fn.n_devices = n_dev
    return fn


def make_sweep_fn(cfg: SimConfig, n_hosts: int, n_nodes: int, horizon: int,
                  devices=None):
    """The stacked sweep: ``fn(sims [S, N], pols [P], params [S]) ->
    (finals, metrics)`` with [P, S, N] leading axes (tensors on the grid's
    device; metrics [P, S, N, T]).  Each cell is ``engine.simulate``, the
    function standalone ``run_sim`` runs, so each is that run bit for
    bit.  With ``devices`` the cells are cut over them (module docstring)
    and their results gathered to the first."""
    devs = resolve_devices(devices)
    n_dev = 1 if devs is None else len(devs)

    def fn(sims, pols, rps):
        home = devs[0] if devs else sims.t.device
        P, S, N, B = _grid_shape(sims, pols)
        finals, metrics = [], []
        for _, _, cell in _grid_cells(sims, pols, rps, devs):
            sim, pol, rp = cell()
            f, m = simulate(sim, cfg, pol, n_hosts, n_nodes, horizon, rp)
            finals.append(_on(home, f))
            metrics.append(_on(home, m))
        grid = lambda x: x.reshape((P, S, N) + tuple(x.shape[1:]))
        return (tree_map(grid, stack_tree(finals)),
                tree_map(grid, stack_tree(metrics)))

    fn.n_devices = n_dev
    return fn


_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32}


def to_host(tensors) -> list:
    """``tensors`` as numpy arrays, packed into one byte buffer on their
    device and copied to the host once."""
    specs = [(t.dtype, tuple(t.shape)) for t in tensors]
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in tensors])
    with trace.host_sync("slab_copy"):
        buf = flat.cpu().numpy()
    out, off = [], 0
    for dtype, shape in specs:
        dt = np.dtype(_NP_DTYPES[dtype])
        size = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        out.append(buf[off:off + size].view(dt).reshape(shape).copy())
        off += size
    return out


def make_stream_fn(cfg: SimConfig, n_hosts: int, n_nodes: int, horizon: int,
                   chunk: int, slab: int | None = None, devices=None,
                   overlap: bool = True, telescope: bool = False):
    """The streamed sweep: the same [P, S, N] grid as ``make_sweep_fn``,
    each cell run in chunks of ``chunk`` ticks (``engine.stream_chunks``,
    the accumulator reset every chunk; ``telescope``: the telescoped
    engine, each cell still its standalone run bit for bit), iterated in
    SLABS of ``slab`` cells.  A slab's finals and per-chunk accumulators
    come to the host in ONE copy (:func:`to_host`), so the device holds
    one slab of final states at a time.

    Returns ``fn(sims, pols, rps) -> (finals, summary)``: finals as host
    numpy with [P, S, N] leading axes (bit for bit the stacked sweep's)
    and a [P, S, N] ``OnlineSummary``.

    ``overlap`` is taken for the JAX package's signature; the port copies
    each slab synchronously whatever it says (no run on the card has shown
    a copy left in flight gaining time).

    ``fn.iter_slabs(sims, pols, rps, slab_starts)`` is the runner itself,
    a generator of ``(s0, finals_leaves, slab_summary)`` per start offset:
    each start owns cells ``s0 .. min(s0 + Bs, B) - 1``, so the last slab
    may be short; ``fn.slab_cells(B)`` is ``Bs``, ``min(slab, B)`` padded
    to a multiple of the device count, so the slab starts are the JAX
    package's.  With ``devices`` each slab is cut over them (module
    docstring), and the cells of each device come to the host in one
    copy.
    """
    stats.check_chunk(chunk, cfg.n_containers)
    devs = resolve_devices(devices)
    n_dev = 1 if devs is None else len(devs)

    def slab_cells(B: int) -> int:
        Bs = B if slab is None else min(slab, B)
        return Bs + (-Bs) % n_dev

    def run_cell(sim, pol, rp):
        accs = []
        sim = stream_chunks(sim, cfg, pol, n_hosts, n_nodes, horizon, chunk,
                            rp, accs.append, telescope=telescope)
        return sim, accs

    def iter_slabs(sims, pols, rps, slab_starts):
        P, S, N, B = _grid_shape(sims, pols)
        Bs = slab_cells(B)
        statics = _static_indices(sims)
        n_fields = len(SummaryAcc._fields)

        def run_shard(cells):
            finals, accs = [], []
            for b, _, cell in cells:
                with trace.span("sweep_cell", b):
                    f, a = run_cell(*cell())
                finals.append([x for _, x in tree_leaves_with_path(f)])
                accs.append(a)
            with trace.span("slab_copy_fold"):
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
            return host[:len(leaves)], slab_sum

        cells = _grid_cells(sims, pols, rps, devs, slab_starts, Bs)
        for first in cells:     # a slab's first cell is its start
            s0 = first[0]
            slab = itertools.chain([first], itertools.islice(
                cells, min(Bs, B - s0) - 1))
            # the cells on one device come to the host together
            parts = [run_shard(shard) for _, shard in
                     itertools.groupby(slab, key=lambda c: c[1])]
            if len(parts) == 1:
                yield (s0,) + parts[0]
                continue
            leaves = [parts[0][0][i] if i in statics
                      else np.concatenate([h[i] for h, _ in parts])
                      for i in range(len(parts[0][0]))]
            yield s0, leaves, OnlineSummary(*(
                np.concatenate(xs) for xs in zip(*(s for _, s in parts))))

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

    fn.n_devices = n_dev
    fn.iter_slabs = iter_slabs
    fn.slab_cells = slab_cells
    return fn


@dataclasses.dataclass
class SweepResult:
    """A sweep's grid and results.  ``n_devices`` counts the devices the
    grid was cut over (a multi-process sweep: workers x devices each);
    ``worker_meta`` holds each worker's slabs, walls, devices and kernel
    launches (``launch.dist``)."""

    policies: list[str]
    scenarios: list[ScenarioSpec]
    seeds: tuple[int, ...]
    finals: SimState          # [P, S, N, ...]
    metrics: TickMetrics | None   # [P, S, N, T]; None when streamed
    wall_s: float
    n_devices: int = 1
    summary: OnlineSummary | None = None  # [P, S, N] streamed fold
    worker_meta: list | None = None  # per-worker meta (launch.dist)
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


def make_grid_fn(cfg: SimConfig, n_hosts: int, n_nodes: int,
                 plan: ExecPlan):
    """The in-process grid runner ``plan`` asks for, over ``cfg.horizon``
    ticks with the plan's kernel selectors folded into ``cfg``:
    :func:`make_stream_fn` at ``plan.stream_chunk``'s chunk (its ``slab``,
    ``devices`` and ``telescope``), else :func:`make_sweep_fn` over
    ``plan.devices``."""
    cfg = plan.apply_to_config(cfg)
    chunk = plan.stream_chunk(cfg.horizon)
    if chunk is None:
        return make_sweep_fn(cfg, n_hosts, n_nodes, cfg.horizon,
                             devices=plan.devices)
    return make_stream_fn(cfg, n_hosts, n_nodes, cfg.horizon, chunk=chunk,
                          slab=plan.slab, devices=plan.devices,
                          overlap=plan.overlap, telescope=plan.telescope)


def run_sweep(policies: Sequence[str] | None = None,
              scenarios: Sequence[ScenarioSpec] | None = None,
              seeds: Sequence[int] = (0,), cfg: SimConfig | None = None,
              n_hosts: int = 20, n_spine: int = 2, n_leaf: int = 4,
              plan: ExecPlan | None = None, device=None) -> SweepResult:
    """Build the grid on ``device`` (default ``cuda``) and run it through
    :func:`make_grid_fn`.

    ``plan.chunk`` switches to the streamed sweep (``make_stream_fn``):
    [P, S, N] summaries without [P, S, N, T] metrics, the grid gathered
    ``plan.slab`` cells at a time.  ``plan.telescope`` streams too, each
    cell telescoped (the whole horizon one chunk without ``plan.chunk``).
    Cell results are bit-identical either way.  ``plan.devices`` cuts the
    cells over several devices (module docstring); ``plan.procs`` is the
    multi-process fabric's (``launch.dist.run_dist_sweep``), as in the
    JAX package this in-process sweep does not read it.  The plan's
    kernel selectors fold into ``cfg`` (:func:`make_grid_fn`)."""
    policies = list(policies if policies is not None else list_policies())
    scenarios = list(scenarios if scenarios is not None
                     else default_scenarios())
    plan = ExecPlan() if plan is None else plan
    cfg = cfg or SimConfig()
    device = resolve_device(device)
    net_spec, sims, rps = build_scenarios(scenarios, cfg, n_hosts=n_hosts,
                                          n_spine=n_spine, n_leaf=n_leaf,
                                          seeds=seeds, device=device)
    pol = stack_policies(policies, device=device)
    fn = make_grid_fn(cfg, net_spec.n_hosts, net_spec.n_nodes, plan)
    t0 = time.time()
    finals, out = fn(sims, pol, rps)
    _synchronize(device)
    streamed = isinstance(out, OnlineSummary)
    return SweepResult(policies=policies, scenarios=scenarios,
                       seeds=tuple(seeds), finals=finals,
                       metrics=None if streamed else out,
                       summary=out if streamed else None,
                       wall_s=round(time.time() - t0, 2),
                       n_devices=fn.n_devices)


def run_sim_vmapped(sims: SimState, cfg: SimConfig, policy: PolicyParams,
                    n_hosts: int, n_nodes: int, horizon: int,
                    params: RunParams | None = None,
                    chunk: int | None = None, telescope: bool = False):
    """Seed-batched single-policy run (a leading [N] axis on every SimState
    leaf), the degenerate 1 x 1 x N sweep: (finals [N, ...], metrics
    [N, T]), or with ``chunk`` or ``telescope`` (finals [N, ...], [N]
    ``OnlineSummary``; telescoped, the whole horizon one chunk without
    ``chunk``).  Each seed is its standalone ``run_sim``."""
    plan = ExecPlan(chunk=chunk, telescope=telescope)
    outs = [run_sim(tree_map(lambda x: x[i], sims), cfg, policy, n_hosts,
                    n_nodes, horizon, params, plan)
            for i in range(sims.t.shape[0])]
    finals, series = zip(*outs)
    if isinstance(series[0], OnlineSummary):
        return (stack_tree(finals),
                OnlineSummary(*(np.stack(xs) for xs in zip(*series))))
    return stack_tree(finals), stack_tree(series)


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
    # the selectors fold here, once, for the rows to report them; the
    # sweep gets the rest of the plan
    cfg = plan.apply_to_config(SimConfig(horizon=args.horizon,
                                         delay_mode=args.delay_mode))
    plan = dataclasses.replace(plan, delay_kernel=None, waterfill_kernel=None)
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
