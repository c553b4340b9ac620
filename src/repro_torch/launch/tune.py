"""Weight search: learn scheduling-policy weights with the sweep.

Counterpart of ``repro.launch.tune``.  A policy IS a point in weight space
(``PolicyParams.weights``), so learning one is a search: sample W weight
vectors, put them on the sweep's policy axis, run the W x scenario x seed
population (``launch.sweep``'s stacked or streamed grid) and rank the
samples by a summary objective (``report.tune_table``).  Random and
per-dimension grid search (:func:`run_tune`) and the cross-entropy method
on the hard simulator (:func:`run_tune_cem`) are ported; the gradient
search comes with the autodiff slice and the multi-process fabric with
its own.

    PYTHONPATH=src python -m repro_torch.launch.tune --samples 16 --seeds 2 \\
        --objective avg_runtime --out tune.json
    PYTHONPATH=src python -m repro_torch.launch.tune --device cpu \\
        --samples 4 --horizon 10 --method cem --steps 2 --batch 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import (SimConfig, get_policy, sweep_summaries,
                              tune_table)
from repro_torch.core.report import json_clean
from repro_torch.core.scenario import ScenarioSpec, build_scenarios
from repro_torch.core.scheduling import validate_weights, weight_index
from repro_torch.core.types import (NUM_POLICY_WEIGHTS, WEIGHT_NAMES,
                                    ExecPlan, PolicyParams, device_name,
                                    resolve_device)
from repro_torch.launch.execargs import add_exec_args
from repro_torch.launch.sweep import (_synchronize, make_stream_fn,
                                      make_sweep_fn)

# Default search space: the cost-model weights of the network-aware score
# plus the co-location / consolidation trade-off.  Everything not named
# here keeps the base policy's value.
DEFAULT_SPACE: dict[str, tuple[float, float]] = {
    "util": (0.0, 4.0),
    "cross_leaf": (0.0, 1.0),
    "row_comm": (0.0, 2.0),
    "row_coloc": (0.0, 2.0),
    "row_fallback_worst": (0.0, 2.0),
    "row_worst_fit": (0.0, 1.0),
    "row_cross_leaf": (0.0, 1.0),
}

# summary metrics where bigger is better (ranked descending)
MAXIMIZE = {"completion_rate", "n_completed", "peak_running",
            "peak_deployed"}


def _base_weights(base: str) -> np.ndarray:
    return get_policy(base, device="cpu").weights.numpy()


def sample_weights(n: int, seed: int = 0, base: str = "netaware",
                   space: dict[str, tuple[float, float]] | None = None,
                   grid: bool = False) -> np.ndarray:
    """[n, NUM_POLICY_WEIGHTS] f32 search population around a registered
    base, drawn with the JAX package's numpy RNG sequence (the same
    arrays).  Random mode draws each searched dimension uniformly; grid
    mode sweeps one dimension at a time over ``(n - 1) // len(space)``
    points spanning ``(lo, hi]``.  Sample 0 is always the untouched base
    vector."""
    space = DEFAULT_SPACE if space is None else space
    idx = {name: weight_index(name) for name in space}   # loud on unknowns
    W = np.tile(_base_weights(base), (n, 1))
    rng = np.random.default_rng(seed)
    if grid:
        names = list(space)
        per = max(1, (n - 1) // len(names))
        i = 1
        for name in names:
            lo, hi = space[name]
            for v in np.linspace(lo, hi, per + 1)[1:]:
                if i < n:
                    W[i, idx[name]] = v
                    i += 1
    else:
        for name, (lo, hi) in space.items():
            W[1:, idx[name]] = rng.uniform(lo, hi, n - 1)
    return W


@dataclasses.dataclass
class TuneResult:
    weights: np.ndarray       # [W, NUM_POLICY_WEIGHTS]
    scores: np.ndarray        # [W] TRUE objective values (NaN = failed)
    objective: str
    minimize: bool            # ranking direction (False for MAXIMIZE)
    rows: list[dict[str, Any]]
    scenarios: list[ScenarioSpec]
    seeds: tuple[int, ...]
    wall_s: float             # first call
    steady_s: float | None    # min of the repeats (``reps > 1``)
    compile_cache_misses: int  # 0: the port compiles nothing
    n_devices: int

    def ranking(self) -> np.ndarray:
        """Sample indices best-first (NaN scores last either way)."""
        return np.argsort(self.scores if self.minimize else -self.scores)

    @property
    def best(self) -> int:
        return int(self.ranking()[0])

    def best_weights(self) -> dict[str, float]:
        return {name: float(v)
                for name, v in zip(WEIGHT_NAMES, self.weights[self.best])}

    def table(self, top: int = 10) -> str:
        return tune_table(self.weights, self.scores, self.objective,
                          top=top, minimize=self.minimize)


@dataclasses.dataclass
class GradTuneResult(TuneResult):
    """A :class:`TuneResult` of an iterative search (the final population
    and its oracle scores) plus its trajectory: the best oracle-scored
    candidate ever seen and a per-step history.  (The JAX package's
    surrogate fields come with the gradient search, in the autodiff
    slice.)"""

    method: str = "cem"
    best_oracle: float = float("nan")
    best_oracle_weights: np.ndarray | None = None
    history: list | None = None
    oracle_evals: int = 0


def _default_scenarios() -> list[ScenarioSpec]:
    return [ScenarioSpec("baseline"),
            ScenarioSpec("slow_net", bw=200.0),
            ScenarioSpec("bursty", arrival="bursty")]


def _make_fn(cfg: SimConfig, net_spec, plan: ExecPlan):
    """The grid runner of the search: streamed with ``plan.chunk``, else
    stacked."""
    if plan.chunk is not None:
        return make_stream_fn(cfg, net_spec.n_hosts, net_spec.n_nodes,
                              cfg.horizon, chunk=plan.chunk, slab=plan.slab,
                              devices=plan.devices, overlap=plan.overlap)
    return make_sweep_fn(cfg, net_spec.n_hosts, net_spec.n_nodes,
                         cfg.horizon, devices=plan.devices)


def _mean_scores(fn, sims, W, rps, scenarios, seeds, objective):
    """Score a weight population: run the grid with the weights on the
    policy axis and mean the summary ``objective`` over every (scenario,
    seed) cell — (scores [W], summary rows)."""
    n = W.shape[0]
    pol = PolicyParams(weights=torch.as_tensor(W, device=sims.t.device))
    finals, metrics = fn(sims, pol, rps)
    names = [f"w{i:03d}" for i in range(n)]
    rows = sweep_summaries(finals, metrics, names,
                           [s.name for s in scenarios], seeds)
    per = {name: [] for name in names}
    for r in rows:
        per[r["policy"]].append(float(r[objective]))
    return np.asarray([np.mean(per[name]) for name in names]), rows


def run_tune(n_samples: int = 16, seeds: Sequence[int] = (0,),
             scenarios: Sequence[ScenarioSpec] | None = None,
             cfg: SimConfig | None = None, n_hosts: int = 20,
             n_spine: int = 2, n_leaf: int = 4,
             objective: str = "avg_runtime", base: str = "netaware",
             space: dict[str, tuple[float, float]] | None = None,
             grid: bool = False, seed: int = 0, reps: int = 1,
             plan: ExecPlan | None = None, device=None) -> TuneResult:
    """Score a whole search population in one grid on ``device``.

    A sample's score is the objective's plain mean over every (scenario,
    seed) cell in the metric's TRUE sign (the ranking direction comes
    from ``MAXIMIZE``); a sample that fails the objective anywhere scores
    NaN and ranks last.  ``reps > 1`` re-runs the grid and records the
    fastest repeat as ``steady_s``.  ``plan.chunk`` streams the grid
    (``launch.sweep.make_stream_fn``); scores match the stacked search to
    float precision, integer objectives exactly."""
    plan = ExecPlan() if plan is None else plan
    cfg = plan.apply_to_config(cfg or SimConfig())
    device = resolve_device(device)
    scenarios = list(scenarios if scenarios is not None
                     else _default_scenarios())
    W = sample_weights(n_samples, seed=seed, base=base, space=space,
                       grid=grid)
    validate_weights(W, "tune samples: ")
    net_spec, sims, rps = build_scenarios(scenarios, cfg, n_hosts=n_hosts,
                                          n_spine=n_spine, n_leaf=n_leaf,
                                          seeds=seeds, device=device)
    fn = _make_fn(cfg, net_spec, plan)
    times = []
    for _ in range(max(reps, 1)):
        t0 = time.time()
        scores, rows = _mean_scores(fn, sims, W, rps, scenarios, seeds,
                                    objective)
        _synchronize(device)
        times.append(time.time() - t0)
    return TuneResult(weights=W, scores=scores, objective=objective,
                      minimize=objective not in MAXIMIZE,
                      rows=rows, scenarios=scenarios, seeds=tuple(seeds),
                      wall_s=round(times[0], 2),
                      steady_s=round(min(times[1:]), 2) if reps > 1 else None,
                      compile_cache_misses=0, n_devices=fn.n_devices)


def _space_bounds(space: dict[str, tuple[float, float]]):
    """(searched index array, lo [W], hi [W])."""
    idx = np.asarray([weight_index(name) for name in space], np.int64)
    lo = np.full((NUM_POLICY_WEIGHTS,), -np.inf, np.float32)
    hi = np.full((NUM_POLICY_WEIGHTS,), np.inf, np.float32)
    for name, (a, b) in space.items():
        lo[weight_index(name)] = a
        hi[weight_index(name)] = b
    return idx, lo, hi


def run_tune_grad(*args, **kwargs):
    """The gradient search descends the soft-placement surrogate, which
    comes with the autodiff slice."""
    raise NotImplementedError(
        "tune --method grad is not ported yet: it comes with the autodiff "
        "slice of repro_torch")


def run_tune_cem(steps: int = 6, batch: int = 16, elite_frac: float = 0.25,
                 init_std_frac: float = 0.3, seeds: Sequence[int] = (0,),
                 scenarios: Sequence[ScenarioSpec] | None = None,
                 cfg: SimConfig | None = None, n_hosts: int = 20,
                 n_spine: int = 2, n_leaf: int = 4,
                 objective: str = "avg_runtime", base: str = "netaware",
                 space: dict[str, tuple[float, float]] | None = None,
                 seed: int = 0, plan: ExecPlan | None = None,
                 device=None) -> GradTuneResult:
    """Cross-entropy search on the hard simulator: sample -> score -> refit
    a diagonal Gaussian to the elite fraction, ``steps`` times, with the
    base policy re-injected as row 0 of every population and the
    best-ever candidate tracked.  The RNG sequence is the JAX package's,
    so equal scores give equal populations."""
    plan = ExecPlan() if plan is None else plan
    cfg = dataclasses.replace(plan.apply_to_config(cfg or SimConfig()),
                              soft_placement=False)
    device = resolve_device(device)
    scenarios = list(scenarios if scenarios is not None
                     else _default_scenarios())
    space = DEFAULT_SPACE if space is None else space
    idx, lo, hi = _space_bounds(space)
    minimize = objective not in MAXIMIZE
    better = (lambda a, b: a < b) if minimize else (lambda a, b: a > b)

    base_w = _base_weights(base)
    net_spec, sims, rps = build_scenarios(scenarios, cfg, n_hosts=n_hosts,
                                          n_spine=n_spine, n_leaf=n_leaf,
                                          seeds=seeds, device=device)
    fn = _make_fn(cfg, net_spec, plan)
    rng = np.random.default_rng(seed)
    mu = base_w[idx].astype(np.float64)
    sd = (hi[idx] - lo[idx]).astype(np.float64) * init_std_frac
    n_elite = max(1, int(round(batch * elite_frac)))

    t_start = time.time()
    history: list[dict[str, Any]] = []
    best_score, best_w = float("inf") if minimize else -float("inf"), base_w
    W = scores = rows = None
    for step in range(steps):
        W = np.tile(base_w, (batch, 1))
        W[1:, idx] = np.clip(rng.normal(mu, sd, (batch - 1, idx.size)),
                             lo[idx], hi[idx])
        W = W.astype(np.float32)
        scores, rows = _mean_scores(fn, sims, W, rps, scenarios, seeds,
                                    objective)
        order = np.argsort(scores if minimize else -scores)
        elite = W[order[:n_elite]][:, idx].astype(np.float64)
        mu = elite.mean(axis=0)
        sd = np.maximum(elite.std(axis=0), 1e-3)
        k = int(order[0])
        if np.isfinite(scores[k]) and better(scores[k], best_score):
            best_score, best_w = float(scores[k]), W[k].copy()
        history.append({"step": step,
                        "oracle_best": (float(np.nanmin(scores)) if minimize
                                        else float(np.nanmax(scores))),
                        "mu": [round(float(v), 4) for v in mu],
                        "sd": [round(float(v), 4) for v in sd]})
    return GradTuneResult(
        weights=W, scores=scores, objective=objective, minimize=minimize,
        rows=rows, scenarios=scenarios, seeds=tuple(seeds),
        wall_s=round(time.time() - t_start, 2), steady_s=None,
        compile_cache_misses=0, n_devices=fn.n_devices, method="cem",
        best_oracle=best_score, best_oracle_weights=best_w,
        history=history, oracle_evals=steps * batch)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="random",
                    choices=["random", "grid", "grad", "cem"],
                    help="random/grid = one-shot population ranking; cem = "
                         "cross-entropy on the hard simulator; grad raises "
                         "until the autodiff slice is ported")
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--seeds", type=int, default=1,
                    help="number of seeds (0..n-1) per cell")
    ap.add_argument("--horizon", type=int, default=120)
    ap.add_argument("--hosts", type=int, default=20)
    ap.add_argument("--objective", default="avg_runtime",
                    help="summary metric to optimize (lower = better; "
                         f"higher for {sorted(MAXIMIZE)})")
    ap.add_argument("--base", default="netaware",
                    help="registered policy the search perturbs")
    ap.add_argument("--grid", action="store_true",
                    help="(random/grid) coordinate-profile grid instead of "
                         "random draws")
    ap.add_argument("--seed", type=int, default=0, help="search RNG seed")
    g = ap.add_argument_group("cem")
    g.add_argument("--steps", type=int, default=6, help="optimizer steps")
    g.add_argument("--batch", type=int, default=16,
                   help="candidates per step")
    g.add_argument("--elite-frac", type=float, default=0.25,
                   help="elite fraction per refit")
    add_exec_args(ap, dist=True)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="write best weights + ranked samples as JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    if args.method == "grad":
        run_tune_grad()
    plan = ExecPlan.from_args(args)
    device = resolve_device(args.device)
    n_leaf = max(4, args.hosts // 5)
    common = dict(seeds=range(args.seeds), cfg=SimConfig(horizon=args.horizon),
                  n_hosts=args.hosts, n_spine=max(2, n_leaf // 4),
                  n_leaf=n_leaf, objective=args.objective, base=args.base,
                  seed=args.seed, plan=plan, device=device)
    if args.method == "cem":
        res = run_tune_cem(steps=args.steps, batch=args.batch,
                           elite_frac=args.elite_frac, **common)
    else:
        res = run_tune(n_samples=args.samples,
                       grid=(args.method == "grid" or args.grid), **common)

    n_cand = res.weights.shape[0]
    cells = n_cand * len(res.scenarios) * len(res.seeds)
    print(f"# {args.method}: {cells} cells/eval ({n_cand} candidates x "
          f"{len(res.scenarios)} scenarios x {len(res.seeds)} seeds) in "
          f"{res.wall_s}s, device={device_name(device)}")
    if isinstance(res, GradTuneResult):
        arrow = "min" if res.minimize else "max"
        print(f"# best oracle {res.objective} ({arrow}): "
              f"{res.best_oracle:.4f} after {res.oracle_evals} evals")
    print(res.table(args.top))
    if args.out:
        out = {"method": args.method,
               "objective": res.objective,
               "best_sample": res.best,
               "best_weights": res.best_weights(),
               "scores": json_clean(list(map(float, res.scores))),
               "weights": [list(map(float, w)) for w in res.weights]}
        if isinstance(res, GradTuneResult):
            out["best_oracle"] = res.best_oracle
            out["best_oracle_weights"] = dict(
                zip(WEIGHT_NAMES, map(float, res.best_oracle_weights)))
            out["history"] = res.history
        with open(args.out, "w") as f:
            json.dump(json_clean(out), f, indent=1)
        print(f"# wrote {args.out}")


if __name__ == "__main__":
    main()
