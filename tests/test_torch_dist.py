"""repro_torch's multi-process sweep fabric (``repro_torch.launch.dist``)
against its own single-process sweep and against the JAX package's.

The grid is ``tests/test_sweep_dist.py``'s: 2 policies x 2 scenarios x 3
seeds at 6 hosts, chunk 8, on the CPU.

* ``stats.online_merge`` (the cross-worker reduction) is an exact
  identity over disjoint support and a correct parallel Welford;
* a ``GridSpec`` round-trips through JSON and its JSON is the JAX
  package's key for key, each package loading the other's;
* uneven partitions through ``run_worker_inline`` (a one-cell grid
  included), a resume that adopts an orphan slab, and one spawned run of
  2 workers x 2 devices (``("cpu", "cpu")``, the TCP handout, the gloo
  group) merge bit for bit to the port's single-process streamed sweep;
* a slab-plan mismatch and a foreign slab plan in ``out_dir`` raise;
* the spawned run is within the whole-run tolerances of the JAX
  package's single-process streamed sweep (ints exactly, finals rtol
  1e-5 / atol 1e-4, summary floats rtol 3e-6), and slabs written by the
  JAX fabric merge here as the JAX package merges them.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.core import SimConfig, get_policy, stats  # noqa: E402
from repro_torch.core.convert import assert_state_close  # noqa: E402
from repro_torch.core.scenario import ScenarioSpec  # noqa: E402
from repro_torch.core.types import ExecPlan, OnlineSummary  # noqa: E402
from repro_torch.launch import dist  # noqa: E402
from repro_torch.launch.sweep import (run_sweep,  # noqa: E402
                                      tree_leaves_with_path)

SCEN = [ScenarioSpec("baseline"), ScenarioSpec("slow_net", bw=200.0)]
POLS = ["firstfit", "netaware"]
SEEDS = (0, 1, 2)
RTOL, ATOL, SUM_RTOL = 1e-5, 1e-4, 3e-6


def tiny_cfg(**kw):
    base = dict(horizon=20, n_jobs=6, n_tasks=12, n_containers=12,
                arrival_window=8.0, placements_per_tick=8,
                migrations_per_tick=2)
    base.update(kw)
    return SimConfig(**base)


def tiny_spec(cfg, *, scenarios=SCEN, policies=POLS, seeds=SEEDS,
              chunk=8, slab=None, devices_per_proc=1):
    return dist.GridSpec.build(
        cfg=cfg, scenarios=scenarios, seeds=seeds, policies=policies,
        n_hosts=6, n_spine=2, n_leaf=4, chunk=chunk, slab=slab,
        overlap=True, devices_per_proc=devices_per_proc)


def reference(spec):
    """The port's single-process streamed sweep over the same grid."""
    return run_sweep(policies=spec.policy_names(),
                     scenarios=spec.scenario_specs(), seeds=spec.seeds,
                     cfg=spec.sim_config(), n_hosts=spec.n_hosts,
                     n_spine=spec.n_spine, n_leaf=spec.n_leaf,
                     plan=ExecPlan(chunk=spec.chunk, slab=spec.slab),
                     device="cpu")


def starts_of(spec, n_dev=1):
    B = spec.n_cells
    return list(range(0, B, dist._slab_cells(B, spec.slab, n_dev)))


def assert_finals_bitwise(a, b):
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert len(la) == len(lb)
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), path


def assert_summary_bitwise(a: OnlineSummary, b: OnlineSummary):
    for name, xa, xb in zip(OnlineSummary._fields, a, b):
        xa, xb = np.asarray(xa), np.asarray(xb)
        assert xa.dtype == xb.dtype and xa.shape == xb.shape, name
        assert np.array_equal(xa.view(np.uint8), xb.view(np.uint8)), name


# ---------------------------------------------------------------------------
# online_merge: the cross-worker reduction
# ---------------------------------------------------------------------------
def _rand_summary(rng, shape):
    n = rng.integers(0, 50, shape)
    xs = [rng.normal(0.5, 0.2, shape) * (n > 0) for _ in range(2)]
    f = lambda x: np.asarray(x, np.float64)
    i = lambda x: np.asarray(x, np.int64)
    return OnlineSummary(
        n_ticks=i(n), sum_util_var=f(xs[0]), sum_mean_util=f(xs[1]),
        sum_flow_rate=f(xs[0] * 3), w_mean_util=f(xs[1] * (n > 0)),
        w_m2_util=f(np.abs(xs[0]) * (n > 0)),
        sum_active_flows=i(n * 2), sum_arrivals=i(n // 2),
        sum_decisions=i(n // 3), sum_migrations=i(n // 5),
        peak_running=i(n % 7), peak_deployed=i(n % 5),
        peak_overloaded=i(n % 3), peak_inactive=i(n % 11),
        sum_soft_comm=f(xs[0] * 2), sum_soft_util=f(xs[1] * 2),
        sum_soft_n=f(n // 2), sum_soft_mig=f(xs[0] * (n > 0)),
        sum_soft_mig_n=f(n // 4))


def test_online_merge_disjoint_support_is_exact_identity():
    rng = np.random.default_rng(0)
    full = _rand_summary(rng, (32,))
    own = rng.random(32) < 0.5
    mask = lambda s, m: OnlineSummary(*(np.where(m, x, x.dtype.type(0))
                                        for x in s))
    a, b = mask(full, own), mask(full, ~own)
    for merged in (stats.online_merge(a, b), stats.online_merge(b, a)):
        assert_summary_bitwise(merged, full)
    zero = stats.online_init((32,))
    assert_summary_bitwise(stats.online_merge(full, zero), full)
    assert_summary_bitwise(stats.online_merge(zero, full), full)
    assert_summary_bitwise(
        stats.online_merge(stats.online_merge(a, zero), b), full)


def test_online_merge_overlapping_matches_direct_welford():
    rng = np.random.default_rng(1)
    xs = rng.normal(0.4, 0.1, 37)

    def welford(vals):
        mean, m2 = 0.0, 0.0
        for k, v in enumerate(vals):
            d = v - mean
            mean += d / (k + 1)
            m2 += d * (v - mean)
        return OnlineSummary(
            *(np.asarray(x, t) for x, t in zip(
                [len(vals), 0, sum(vals), 0, mean, m2,
                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                [np.int64] + [np.float64] * 5 + [np.int64] * 8
                + [np.float64] * 5)))
    for split in (1, 13, 36):
        merged = stats.online_merge(welford(xs[:split]), welford(xs[split:]))
        ref = welford(xs)
        assert int(merged.n_ticks) == 37
        np.testing.assert_allclose(merged.w_mean_util, ref.w_mean_util,
                                   rtol=1e-12)
        np.testing.assert_allclose(merged.w_m2_util, ref.w_m2_util,
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(merged.sum_mean_util, ref.sum_mean_util,
                                   rtol=1e-12)


# ---------------------------------------------------------------------------
# GridSpec: the launcher <-> worker contract, and the JAX package's JSON
# ---------------------------------------------------------------------------
def test_grid_spec_json_roundtrip(tmp_path):
    cfg = tiny_cfg(duration_range=(5.0, 9.0))
    spec = tiny_spec(cfg, slab=5)
    p = str(tmp_path / "spec.json")
    spec.save(p)
    back = dist.GridSpec.load(p)
    assert back.sim_config() == cfg          # tuple fields restored
    assert back.scenario_specs() == spec.scenario_specs()
    assert back.policy_names() == POLS
    assert torch.equal(back.policy_params("cpu").weights,
                       spec.policy_params("cpu").weights)
    assert back.n_cells == 2 * 2 * 3

    W = spec.policy_params("cpu").weights.numpy()   # raw-weights variant
    wspec = dist.GridSpec.build(
        cfg=cfg, scenarios=SCEN, seeds=(0,), weights=W, n_hosts=6,
        n_spine=2, n_leaf=4, chunk=8, slab=None, overlap=False,
        devices_per_proc=2)
    wspec.save(p)
    wback = dist.GridSpec.load(p)
    assert wback.policy_names() == ["w000", "w001"]
    assert np.array_equal(wback.policy_params("cpu").weights.numpy(), W)
    with pytest.raises(ValueError, match="exactly one"):
        dist.GridSpec.build(cfg=cfg, scenarios=SCEN, seeds=(0,),
                            policies=POLS, weights=W, n_hosts=6, n_spine=2,
                            n_leaf=4, chunk=8, slab=None, overlap=True,
                            devices_per_proc=1)


def test_grid_spec_json_is_the_jax_packages(tmp_path):
    from repro.core import SimConfig as JSimConfig
    from repro.core.scenario import ScenarioSpec as JSpec
    from repro.launch import dist as jdist
    kw = dict(horizon=20, n_jobs=6, n_tasks=12, n_containers=12,
              arrival_window=8.0, placements_per_tick=8,
              migrations_per_tick=2, duration_range=(5.0, 9.0))
    jscen = [JSpec(**dataclasses.asdict(s)) for s in SCEN]
    common = dict(seeds=SEEDS, n_hosts=6, n_spine=2, n_leaf=4, chunk=8,
                  slab=5, overlap=True, devices_per_proc=2)
    W = (get_policy("netaware", device="cpu").weights.numpy()[None]
         * np.random.default_rng(3).uniform(0.5, 2.0, (3, 1))
         ).astype(np.float32)
    for by in ({"policies": POLS}, {"weights": W}):
        tspec = dist.GridSpec.build(cfg=SimConfig(**kw), scenarios=SCEN,
                                    **by, **common)
        jspec = jdist.GridSpec.build(cfg=JSimConfig(**kw), scenarios=jscen,
                                     **by, **common)
        tp, jp = str(tmp_path / "t.json"), str(tmp_path / "j.json")
        tspec.save(tp)
        jspec.save(jp)
        with open(tp) as f, open(jp) as g:
            tj, jj = json.load(f), json.load(g)
        assert list(tj) == list(jj)
        assert list(tj["config"]) == list(jj["config"])
        assert tj == jj
        # each package loads the other's file
        assert dist.GridSpec.load(jp).sim_config() == SimConfig(**kw)
        assert jdist.GridSpec.load(tp).sim_config() == JSimConfig(**kw)
        assert dist.GridSpec.load(jp).n_cells == jspec.n_cells


# ---------------------------------------------------------------------------
# Uneven partitions, resume and the slab plan: bit for bit the sweep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("plan", [
    # (slab, worker share of the slab-start list) — B = 12 cells
    (5, [1, 2]),          # B % slab != 0: the last slab is short
    (2, [1, 4, 1]),       # slab far below the fair share, 3 workers
    (12, [1]),            # one worker owns the whole grid in one slab
])
def test_uneven_partitions_bitwise(tmp_path, plan):
    slab, shares = plan
    spec = tiny_spec(tiny_cfg(), slab=slab)
    starts = starts_of(spec)
    assert sum(shares) == len(starts), "plan must cover every slab"
    ref = reference(spec)
    out = str(tmp_path / "run")
    k = 0
    for wid, share in enumerate(shares):
        dist.run_worker_inline(spec, out, wid, starts[k:k + share],
                               device="cpu")
        k += share
    finals, summary, metas = dist.merge_out_dir(spec, out)
    assert_finals_bitwise(ref.finals, finals)
    assert_summary_bitwise(ref.summary, summary)
    assert sorted(s for m in metas for s in m["slabs"]) == starts


def test_one_cell_grid_bitwise(tmp_path):
    spec = tiny_spec(tiny_cfg(), scenarios=[SCEN[0]], policies=["netaware"],
                     seeds=(0,))
    assert spec.n_cells == 1
    ref = reference(spec)
    out = str(tmp_path / "run")
    dist.run_worker_inline(spec, out, 0, [0], device="cpu")
    finals, summary, _ = dist.merge_out_dir(spec, out)
    assert_finals_bitwise(ref.finals, finals)
    assert_summary_bitwise(ref.summary, summary)


def test_slab_plan_mismatch_is_loud(tmp_path):
    # a worker whose device count pads the slab differently than the spec
    # planned must refuse to run, not silently diverge ownership
    spec = tiny_spec(tiny_cfg(), slab=5, devices_per_proc=4)
    with pytest.raises(RuntimeError, match="pad the slab"):
        dist.run_worker_inline(spec, str(tmp_path), 0, [0],
                               devices=("cpu",))
    if not torch.cuda.is_available():   # a worker never falls back
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dist.run_worker_inline(spec, str(tmp_path), 0, [0])


def test_resume_skips_done_and_adopts_orphans(tmp_path):
    spec = tiny_spec(tiny_cfg(), slab=5, devices_per_proc=2)
    starts = starts_of(spec, 2)
    assert starts == [0, 6]                  # slab 5 pads to 6 cells
    ref = reference(spec)
    out = str(tmp_path / "run")
    # a "crashed" first run: one slab done, its worker died before its meta
    dist.run_worker_inline(spec, out, 0, starts[:1], device="cpu")
    os.remove(os.path.join(out, "worker_00.json"))
    assert dist.completed_slab_starts(out) == {starts[0]}
    with pytest.raises(RuntimeError, match="incomplete"):
        dist.merge_out_dir(spec, out)
    remaining = [s for s in starts
                 if s not in dist.completed_slab_starts(out)]
    assert remaining == starts[1:]
    meta = dist.run_worker_inline(spec, out, 1, remaining, device="cpu")
    assert meta["devices"] == ["cpu", "cpu"] and meta["n_local_devices"] == 2
    finals, summary, metas = dist.merge_out_dir(spec, out)
    assert_finals_bitwise(ref.finals, finals)
    assert_summary_bitwise(ref.summary, summary)
    assert [m["process_index"] for m in metas] == [1]   # orphan adopted


def test_merge_rejects_foreign_slab_plan(tmp_path):
    spec = tiny_spec(tiny_cfg(), slab=5)
    out = str(tmp_path / "run")
    dist.run_worker_inline(spec, out, 0, starts_of(spec), device="cpu")
    other = dataclasses.replace(spec, slab=4)
    with pytest.raises(RuntimeError, match="different grid/slab plan"):
        dist.merge_out_dir(other, out)


# ---------------------------------------------------------------------------
# Spawned: 2 workers x 2 devices, the TCP handout and the gloo group
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist") / "run")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        res = dist.run_dist_sweep(
            policies=POLS, scenarios=SCEN, seeds=SEEDS, cfg=tiny_cfg(),
            n_hosts=6, n_spine=2, n_leaf=4,
            plan=ExecPlan(chunk=8, slab=4, procs=2, devices_per_proc=2),
            out_dir=out, device="cpu", timeout_s=240.0)
    return res, out


def test_dist_sweep_spawned_2proc_2dev(spawned):
    res, out = spawned
    ref = reference(tiny_spec(tiny_cfg(), slab=4))
    assert_finals_bitwise(ref.finals, res.finals)
    assert_summary_bitwise(ref.summary, res.summary)
    assert res.n_devices == 4 and len(res.worker_meta) == 2
    B = len(POLS) * len(SCEN) * len(SEEDS)
    starts = list(range(0, B, dist._slab_cells(B, 4, 2)))
    with open(os.path.join(out, "coordinator.json")) as f:
        coord = json.load(f)
    assigned = sorted(s for ss in coord["assignments"].values() for s in ss)
    assert assigned == starts          # every slab handed out exactly once
    for m in res.worker_meta:
        assert m["devices"] == ["cpu", "cpu"] and m["backend"] == "torch-cpu"
        assert m["slabs"] == coord["assignments"].get(
            str(m["process_index"]), [])
        assert len(m["slab_walls_s"]) == len(m["slabs"])
        assert m["startup_s"] > 0
        assert set(m["launches"].values()) == {0}   # plain versions here
        assert m["kernels_active"] == {"seg_waterfill": False,
                                       "fw_minplus": False}
    assert sorted(s for m in res.worker_meta for s in m["slabs"]) == starts
    rows, ref_rows = res.summaries(), ref.summaries()
    assert len(rows) == len(ref_rows) == B
    for ra, rb in zip(ref_rows, rows):
        assert ra.keys() == rb.keys()
        for k in ra:
            va, vb = ra[k], rb[k]
            if isinstance(va, float) and np.isnan(va):
                assert np.isnan(vb), k
            else:
                assert va == vb, k


def jax_streamed_sweep():
    import jax
    from repro.core import SimConfig as JSimConfig
    from repro.core.scenario import ScenarioSpec as JSpec
    from repro.core.types import ExecPlan as JExecPlan
    from repro.launch.sweep import run_sweep as jrun_sweep
    jscen = [JSpec(**dataclasses.asdict(s)) for s in SCEN]
    res = jrun_sweep(policies=POLS, scenarios=jscen, seeds=SEEDS,
                     cfg=JSimConfig(**dataclasses.asdict(tiny_cfg())),
                     n_hosts=6, n_spine=2, n_leaf=4,
                     plan=JExecPlan(chunk=8, slab=4))
    return res, jax.device_get(res.finals)


def test_dist_sweep_matches_jax(spawned):
    res, _ = spawned
    jres, jfinals = jax_streamed_sweep()
    assert_state_close(jfinals, res.finals, RTOL, ATOL)
    for f, a, b in zip(OnlineSummary._fields, jres.summary, res.summary):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=SUM_RTOL, err_msg=f)
    assert int(res.summary.sum_decisions.sum()) > 0


def test_jax_slabs_merge_in_the_port(tmp_path):
    """Slabs written by the JAX fabric merge here as the JAX package merges
    them (bit for bit, every leaf but the JAX state's rng), and a port slab
    restores through the JAX checkpoint module leaf for leaf."""
    import jax
    from repro.distributed import checkpoint as jckpt
    from repro.launch import dist as jdist
    spec = tiny_spec(tiny_cfg(), slab=5)
    spec_path = str(tmp_path / "spec.json")
    spec.save(spec_path)
    jspec = jdist.GridSpec.load(spec_path)
    jout = str(tmp_path / "jax")
    jdist.run_worker_inline(jspec, jout, 0, starts_of(spec))
    jfinals, jsummary, _ = jdist.merge_out_dir(jspec, jout)
    finals, summary, metas = dist.merge_out_dir(spec, jout)
    assert [m["process_index"] for m in metas] == [0]
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jfinals)]
    tleaves = [x for _, x in tree_leaves_with_path(finals)]
    assert len(jleaves) == len(tleaves) + 1     # the rng leaf
    for x, y in zip(jleaves, tleaves):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert_summary_bitwise(OnlineSummary(*map(np.asarray, jsummary)),
                           summary)

    tout = str(tmp_path / "port")
    dist.run_worker_inline(spec, tout, 0, [0], device="cpu")
    like = {"finals": {}, "summary": {}}
    with open(os.path.join(tout, "slab_00000000", "manifest.json")) as f:
        for key, leaf in json.load(f)["leaves"].items():
            group, name = key.split("/")
            like[group][name] = np.empty(leaf["shape"], leaf["dtype"])
    jstate, step = jckpt.restore_checkpoint(
        os.path.join(tout, "slab_00000000"), like)
    tstate, tstep = dist.ckpt.restore_checkpoint(
        os.path.join(tout, "slab_00000000"), like)
    assert step == tstep == 0
    assert len(like["finals"]) == len(tleaves) + 1 - len(   # + rng
        dist._static_indices(dist.build_grid(spec, "cpu").sims))
    for group in like:
        for name in like[group]:
            a, b = jstate[group][name], tstate[group][name]
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_port_slabs_merge_in_jax(tmp_path):
    """Slabs written by the port merge in the JAX package: its finals equal
    the port's merge bit for bit, plus the rng leaf, equal to the JAX
    run's; its summary equals the port's bit for bit."""
    import jax
    from repro.launch import dist as jdist
    spec = tiny_spec(tiny_cfg(), slab=5)
    spec_path = str(tmp_path / "spec.json")
    spec.save(spec_path)
    jspec = jdist.GridSpec.load(spec_path)
    tout = str(tmp_path / "port")
    dist.run_worker_inline(spec, tout, 0, starts_of(spec), device="cpu")
    finals, summary, _ = dist.merge_out_dir(spec, tout)
    jfinals, jsummary, jmetas = jdist.merge_out_dir(jspec, tout)
    assert [m["process_index"] for m in jmetas] == [0]
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jfinals)]
    tleaves = [x for _, x in tree_leaves_with_path(finals)]
    assert len(jleaves) == len(tleaves) + 1     # the rng leaf, last
    for x, y in zip(jleaves, tleaves):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8))
    assert_summary_bitwise(OnlineSummary(*map(np.asarray, jsummary)),
                           summary)
    jout = str(tmp_path / "jax")
    jdist.run_worker_inline(jspec, jout, 0, starts_of(spec))
    jref, _, _ = jdist.merge_out_dir(jspec, jout)
    rng = np.asarray(jref.rng)
    assert rng.dtype == np.uint32 and rng.shape == (2, 2, 3, 2)
    assert np.array_equal(jleaves[-1], rng)
    assert np.array_equal(rng[..., 1], np.broadcast_to(SEEDS, (2, 2, 3)))
