"""repro_torch.launch.tune against repro.launch.tune.

* ``sample_weights``, random and grid: the JAX package's arrays exactly;
* ``run_tune`` with 4 samples on a small grid: scores within rtol 1e-5 of
  the JAX package's, integer objectives exactly, the same ranking;
* ``run_tune_cem`` with 2 steps of 4 candidates: every population the JAX
  one bit for bit (the first depends on the numpy seed alone; the elite
  sets agree on this grid, so the later ones follow), the oracle scores
  within rtol 1e-5;
* several processes raise, naming their slice, with ``--telescope`` too
  (telescoping itself: ``tests/test_torch_telescope.py``).
"""
import contextlib
import functools
import io
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.core import SimConfig  # noqa: E402
from repro_torch.core.scenario import ScenarioSpec  # noqa: E402
from repro_torch.core.types import ExecPlan  # noqa: E402
from repro_torch.launch import tune as ttune  # noqa: E402

SMALL = dict(n_jobs=10, n_tasks=40, n_containers=40, horizon=30,
             arrival_window=10.0, placements_per_tick=16,
             migrations_per_tick=2)
HOSTS = dict(n_hosts=8, n_spine=2, n_leaf=4)
SPECS = (("baseline", {}), ("slow_net", {"bw": 200.0}))
RTOL = 1e-5


def port_specs():
    return [ScenarioSpec(n, **kw) for n, kw in SPECS]


def jax_specs():
    from repro.core.scenario import ScenarioSpec as JSpec
    return [JSpec(n, **kw) for n, kw in SPECS]


@pytest.mark.parametrize("n,seed,grid", [(4, 0, False), (16, 3, False),
                                         (15, 0, True), (3, 1, True)])
def test_sample_weights_match_jax_exactly(n, seed, grid):
    from repro.launch.tune import sample_weights as jsample
    want = jsample(n, seed=seed, grid=grid)
    got = ttune.sample_weights(n, seed=seed, grid=grid)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert np.array_equal(got[0], ttune._base_weights("netaware"))
    space = {"util": (0.5, 2.0), "row_comm": (0.0, 1.0)}
    assert np.array_equal(
        ttune.sample_weights(n, seed=seed, grid=grid, base="firstfit",
                             space=space),
        jsample(n, seed=seed, grid=grid, base="firstfit", space=space))


@functools.lru_cache(maxsize=None)
def tune_pair(objective):
    from repro.core import SimConfig as JSimConfig
    from repro.launch.tune import run_tune as jrun_tune
    kw = dict(n_samples=4, seeds=(0,), objective=objective, **HOSTS)
    jres = jrun_tune(scenarios=jax_specs(), cfg=JSimConfig(**SMALL), **kw)
    tres = ttune.run_tune(scenarios=port_specs(), cfg=SimConfig(**SMALL),
                          device="cpu", **kw)
    return jres, tres


def test_run_tune_matches_jax():
    jres, tres = tune_pair("avg_runtime")
    assert np.array_equal(tres.weights, jres.weights)
    np.testing.assert_allclose(tres.scores, jres.scores, rtol=RTOL)
    assert np.isfinite(tres.scores).all()
    assert list(tres.ranking()) == list(jres.ranking())
    assert tres.table() == jres.table()
    assert tres.best_weights() == jres.best_weights()
    assert tres.n_devices == 1
    # integer objectives exactly, from the same rows
    for key in ("total_decisions", "n_completed", "flow_ticks"):
        per = lambda rows: [[r[key] for r in rows if r["policy"] == p]
                            for p in sorted({r["policy"] for r in rows})]
        assert per(tres.rows) == per(jres.rows), key


def test_streamed_tune_equals_stacked():
    _, stacked = tune_pair("avg_runtime")
    streamed = ttune.run_tune(scenarios=port_specs(), cfg=SimConfig(**SMALL),
                              n_samples=4, seeds=(0,), device="cpu",
                              plan=ExecPlan(chunk=11, slab=3), **HOSTS)
    np.testing.assert_allclose(streamed.scores, stacked.scores, rtol=3e-6)
    assert list(streamed.ranking()) == list(stacked.ranking())


def test_maximize_objective_ranks_descending():
    jres, tres = tune_pair("n_completed")
    assert not tres.minimize
    np.testing.assert_array_equal(tres.scores, jres.scores)
    assert list(tres.ranking()) == list(jres.ranking())
    assert tres.scores[tres.best] == tres.scores.max()


def record_populations(monkeypatch, module):
    seen = []
    inner = module._mean_scores

    def spy(fn, sims, W, *args):
        seen.append(np.array(W))
        return inner(fn, sims, W, *args)

    monkeypatch.setattr(module, "_mean_scores", spy)
    return seen


def test_run_tune_cem_matches_jax(monkeypatch):
    from repro.core import SimConfig as JSimConfig
    from repro.launch import tune as jtune
    kw = dict(steps=2, batch=4, seeds=(0,), seed=2, **HOSTS)
    jpops = record_populations(monkeypatch, jtune)
    tpops = record_populations(monkeypatch, ttune)
    jres = jtune.run_tune_cem(scenarios=jax_specs(),
                              cfg=JSimConfig(**SMALL), **kw)
    tres = ttune.run_tune_cem(scenarios=port_specs(), cfg=SimConfig(**SMALL),
                              device="cpu", **kw)
    assert len(tpops) == len(jpops) == 2
    for a, b in zip(tpops, jpops):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    np.testing.assert_allclose(tres.scores, jres.scores, rtol=RTOL)
    np.testing.assert_allclose(tres.best_oracle, jres.best_oracle, rtol=RTOL)
    assert np.array_equal(tres.best_oracle_weights, jres.best_oracle_weights)
    assert [h["mu"] for h in tres.history] == [h["mu"] for h in jres.history]
    assert tres.method == "cem" and tres.oracle_evals == jres.oracle_evals


def test_unported_searches_raise_naming_their_slice(tmp_path, monkeypatch):
    """``--procs`` runs the random search through the multi-process fabric
    with the in-process scores exactly; without ``--chunk``, with
    ``--telescope`` and with ``--method grad`` it raises as in JAX."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(ValueError, match="requires chunk"):
        ttune.main(["--device", "cpu", "--procs", "2"])
    with pytest.raises(ValueError, match="telescope is not threaded"):
        ttune.main(["--device", "cpu", "--procs", "2", "--chunk", "8",
                    "--telescope"])
    with pytest.raises(ValueError, match="grad mode is single-process"):
        ttune.main(["--device", "cpu", "--method", "grad", "--procs", "2",
                    "--chunk", "8"])
    scores = []
    for extra in ([], ["--procs", "2", "--devices-per-proc", "2"]):
        out = tmp_path / f"tune{len(extra)}.json"
        with contextlib.redirect_stdout(io.StringIO()):
            ttune.main(["--device", "cpu", "--samples", "3", "--hosts", "6",
                        "--horizon", "20", "--chunk", "8", "--out", str(out)]
                       + extra)
        scores.append(json.loads(out.read_text())["scores"])
    assert scores[0] == scores[1]
    assert all(np.isfinite(s) for s in scores[0])


def test_tune_cli_runs_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ttune.main(["--device", "cpu", "--samples", "3", "--horizon", "8",
                    "--method", "grid"])
    head, title, *rest = out.getvalue().strip().splitlines()
    assert head.startswith("# grid: 9 cells/eval (3 candidates x 3 "
                           "scenarios x 1 seeds)") and "device=cpu" in head
    assert title == "best weights by avg_runtime (lower = better)"
    assert len(rest) == 1 + 3
