"""repro_torch's spans and counters (``core/trace.py``), on the CPU.

* off (no profiler): no clock read, nothing recorded, one shared no-op
  context;
* under ``torch.profiler``: spans nest with their parents and ids,
  counts land on the innermost span, a new profiler session starts the
  records anew, and a ``record_function`` range opened inside a span lies
  within the span's stamps (one clock);
* on small episodes of the paper testbed, per-tick and telescoped, and a
  small streamed sweep: the ``host_sync`` spans by site are the
  read-backs the path makes (counted by stand-ins for the tensor's
  read-back methods), ``candidates`` the admit loop's iterations,
  ``admitted`` the decisions, and the final state and summary the same
  bit for bit with a profiler on and off;
* ``launch/profile.py``: the device busy time is the union of the
  events' intervals, and the port's records are read per tick.
"""
import json
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

from repro_torch.core import (SimConfig, get_policy, run_sim,  # noqa: E402
                              scheduling, trace)
from repro_torch.core.scenario import (ScenarioSpec,  # noqa: E402
                                       build_scenarios)
from repro_torch.core.types import ExecPlan  # noqa: E402
from repro_torch.launch import profile as tprofile  # noqa: E402
from repro_torch.launch import sweep as tsweep  # noqa: E402
from repro_torch.launch.sim import build_once  # noqa: E402

CPU = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def no_profiler_before():
    """Each test starts as the port does between profiled windows: a
    call into the module with no profiler running."""
    assert not torch.autograd._profiler_enabled()
    trace.count("outside", 1)


def named(snap, name):
    return [s for s in snap.spans if s.name == name]


def leaves(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for sub in tree for x in leaves(sub)]
    return [tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)]


def assert_bitwise(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape and x.dtype == y.dtype, i
        assert np.ascontiguousarray(x).tobytes() \
            == np.ascontiguousarray(y).tobytes(), i


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------
def test_off_path_reads_no_clock_and_records_nothing(monkeypatch):
    with profile(activities=CPU):
        with trace.span("kept", 1):
            trace.count("n", 2)
    before = trace.snapshot()
    calls = []
    monkeypatch.setattr(trace.time, "time_ns",
                        lambda: calls.append(1) or 0)
    assert not torch.autograd._profiler_enabled()
    for _ in range(3):
        with trace.span("tick", 0) as s:
            assert s is None
            trace.count("candidates", 5)
            with trace.host_sync("admit_count"):
                pass
    assert trace.span("a") is trace.OFF and trace.host_sync("b") is trace.OFF
    # a whole episode's tick path, off
    run_episode(ExecPlan(chunk=4), horizon=4)
    assert calls == []
    assert trace.snapshot() == before


def test_spans_nest_with_parents_and_ids_and_counts_land_innermost():
    """Spans take the innermost open span as parent; counts made inside
    spans or outside them land in the window's totals."""
    with profile(activities=CPU):
        with trace.span("tick", 7):
            trace.count("candidates", 3)
            with trace.span("admit_round"):
                trace.count("candidates", 4)
                with trace.host_sync("admit_count"):
                    pass
            with trace.span("telescope_advance"):
                with trace.host_sync("telescope_event"):
                    pass
        with trace.span("tick", 8):
            pass
        trace.count("loose", 1)
    snap = trace.snapshot()
    got = [(s.name, s.id, s.parent) for s in snap.spans]
    assert got == [("tick", 7, -1), ("admit_round", None, 0),
                   ("host_sync", "admit_count", 1),
                   ("telescope_advance", None, 0),
                   ("host_sync", "telescope_event", 3), ("tick", 8, -1)]
    assert snap.totals == {"candidates": 7, "syncs": 2, "loose": 1}
    assert trace.syncs_by_site(snap) == {"admit_count": 1,
                                         "telescope_event": 1}
    ns, n = trace.self_ns(snap, "tick")
    t7, t8 = snap.spans[0], snap.spans[5]
    kids = sum(snap.spans[i].end_ns - snap.spans[i].start_ns for i in (1, 3))
    assert n == 2 and ns == (t7.end_ns - t7.start_ns - kids
                             + t8.end_ns - t8.start_ns)
    for s in snap.spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = snap.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_a_new_profiler_session_starts_the_records_anew():
    with profile(activities=CPU):
        with trace.span("first"):
            trace.count("n", 1)
    assert [s.name for s in trace.snapshot().spans] == ["first"]
    with trace.span("between"):         # the port's code between windows
        pass
    with profile(activities=CPU):
        with trace.span("second"):
            trace.count("m", 2)
    snap = trace.snapshot()
    assert [s.name for s in snap.spans] == ["second"]
    assert snap.totals == {"m": 2}
    # two windows with only the reading of the first between them
    with profile(activities=CPU):
        with trace.span("third"):
            pass
    assert [s.name for s in trace.snapshot().spans] == ["third"]


def test_a_span_left_open_across_a_new_session_does_not_unbalance_it():
    with profile(activities=CPU):
        outer = trace.span("outer")
        outer.__enter__()
    trace.count("off", 1)
    with profile(activities=CPU):
        with trace.span("inner"):
            pass
        outer.__exit__(None, None, None)
        with trace.span("after"):
            pass
    assert [(s.name, s.parent) for s in trace.snapshot().spans] \
        == [("inner", -1), ("after", -1)]


def test_record_function_inside_a_span_lies_within_its_stamps():
    with profile(activities=CPU) as prof:
        with trace.span("outer"):
            time.sleep(0.002)
            with record_function("inner_range"):
                time.sleep(0.001)
            time.sleep(0.002)
    span, = named(trace.snapshot(), "outer")
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "inner_range"]
    assert len(ev) == 1
    start, end = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    assert span.start_ns <= start < end <= span.end_ns


# ---------------------------------------------------------------------------
# The tick path
# ---------------------------------------------------------------------------
def run_episode(plan, horizon=12):
    """The paper testbed (20 hosts, Fig 3 fabric) and 60 of Table 6's
    containers arriving in 4 s, netaware: migrations start, and the
    telescoped engine finds quiet intervals once they have run."""
    cfg = SimConfig(horizon=horizon, n_jobs=20, n_tasks=60, n_containers=60,
                    arrival_window=4.0)
    spec, sim0, params = build_once(cfg, n_hosts=20, device="cpu")
    return run_sim(sim0, cfg, get_policy("netaware", device="cpu"),
                   spec.n_hosts, spec.n_nodes, horizon, params, plan=plan)


class ReadBacks:
    """Stand-ins for the tensor methods that copy a value to the host,
    counting each call made on a tensor."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("__bool__", "__int__", "__float__", "item", "tolist",
                     "cpu", "numpy"):
            real = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self.wrap(real))

    def wrap(self, real):
        def counted(t, *args, **kwargs):
            self.n += 1
            return real(t, *args, **kwargs)
        return counted


@pytest.mark.parametrize("plan", [ExecPlan(chunk=16),
                                  ExecPlan(chunk=16, telescope=True)],
                         ids=["per_tick", "telescoped"])
def test_syncs_by_site_are_the_read_backs_the_path_makes(plan, monkeypatch):
    horizon = 48
    rows = []
    real = scheduling.host_row_cols

    def row(*args, **kwargs):
        rows.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(scheduling, "host_row_cols", row)
    with profile(activities=CPU):
        rb = ReadBacks(monkeypatch)
        _, online = run_episode(plan, horizon=horizon)
        n_read = rb.n
    monkeypatch.undo()
    snap = trace.snapshot()
    by_site = trace.syncs_by_site(snap)
    ticks = named(snap, "tick")
    assert [s.id for s in ticks] == sorted(s.id for s in ticks)
    # one read-back a host_sync span, and none outside them; the summary
    # copy ends in numpy (.cpu().numpy(): two calls, one copy)
    assert n_read == sum(by_site.values()) + by_site["summary_copy"]
    assert snap.totals["syncs"] == sum(by_site.values())
    assert by_site["admit_count"] == by_site["mig_enabled"] == len(ticks)
    assert 0 < by_site["mig_step"] \
        <= SimConfig().migrations_per_tick * len(ticks)
    assert by_site["summary_copy"] == -(-horizon // plan.chunk)
    assert snap.totals["candidates"] == len(rows) > 0
    assert snap.totals["admitted"] == int(online.sum_decisions) > 0
    if plan.telescope:
        assert 0 < len(ticks) < horizon         # cheap ticks between
        adv = named(snap, "telescope_advance")
        assert len(adv) == len(ticks)
        assert by_site["telescope_horizon"] <= len(adv)
        assert by_site["telescope_event"] >= 1
        for s in snap.spans:
            if s.name == "host_sync" and s.id.startswith("telescope"):
                assert snap.spans[s.parent].name == "telescope_advance"
    else:
        assert len(ticks) == horizon
        assert set(by_site) <= {"admit_count", "mig_enabled", "mig_step",
                                "summary_copy"}
    # five releases of host resources a full tick, none in a cheap one
    frees = named(snap, "free_resources")
    assert len(frees) == 5 * len(ticks)
    for s in snap.spans:
        if s.name in ("admit_round", "free_resources"):
            assert snap.spans[s.parent].name == "tick"
        if s.name == "host_sync" and s.id == "admit_count":
            assert snap.spans[s.parent].name == "admit_round"


@pytest.mark.parametrize("plan", [ExecPlan(chunk=5),
                                  ExecPlan(chunk=8, telescope=True)],
                         ids=["per_tick", "telescoped"])
def test_state_and_summary_are_the_same_with_a_profiler_on_and_off(plan):
    f_off, s_off = run_episode(plan, horizon=16)
    with profile(activities=CPU):
        f_on, s_on = run_episode(plan, horizon=16)
    assert named(trace.snapshot(), "tick")
    assert_bitwise(f_off, f_on)
    assert_bitwise(s_off, s_on)


def test_sweep_cells_and_slabs_are_spans_of_the_stream():
    cfg = SimConfig(n_jobs=10, n_tasks=30, n_containers=30, horizon=6,
                    arrival_window=3.0)
    spec, sims, rps = build_scenarios([ScenarioSpec("baseline")], cfg,
                                      n_hosts=8, n_spine=2, n_leaf=4,
                                      seeds=(0, 1), device="cpu")
    pols = tsweep.stack_policies(["firstfit", "netaware"], device="cpu")
    fn = tsweep.make_stream_fn(cfg, spec.n_hosts, spec.n_nodes, 6, chunk=4,
                               slab=3)
    off = fn(sims, pols, rps)
    with profile(activities=CPU):
        on = fn(sims, pols, rps)
    snap = trace.snapshot()
    cells = named(snap, "sweep_cell")
    assert [s.id for s in cells] == [0, 1, 2, 3]
    assert all(s.parent == -1 for s in cells)
    idx = {i for i, s in enumerate(snap.spans) if s.name == "sweep_cell"}
    ticks = named(snap, "tick")
    assert len(ticks) == 4 * 6 and all(s.parent in idx for s in ticks)
    slabs = named(snap, "slab_copy_fold")
    assert len(slabs) == 2 and trace.syncs_by_site(snap)["slab_copy"] == 2
    for s in snap.spans:
        if s.name == "host_sync" and s.id == "slab_copy":
            assert snap.spans[s.parent].name == "slab_copy_fold"
    assert "summary_copy" not in trace.syncs_by_site(snap)   # folded from host numpy
    assert_bitwise(off[0], on[0])
    assert_bitwise(off[1], on[1])


# ---------------------------------------------------------------------------
# launch/profile.py
# ---------------------------------------------------------------------------
def event(name, start, end, device=DeviceType.CUDA):
    return SimpleNamespace(
        name=name, device_type=device,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def test_device_summary_takes_the_union_of_overlapping_events():
    events = [event("fw_panels", 0, 600), event("fw_tiles", 400, 1000),
              event("fw_tiles", 900, 1200), event("waterfill", 2000, 2100),
              event("cudaLaunchKernel", 0, 5, DeviceType.CPU),
              event("phase_flows", 0, 5000)]
    launches, kernels, device_ms = tprofile.device_summary(
        events, exclude=("phase_flows",))
    assert launches == 1
    assert kernels["fw_tiles"] == [pytest.approx(0.9), 2]
    assert device_ms == pytest.approx(1.3)      # not the summed 1.8
    assert tprofile.union_ms([]) == 0.0
    assert tprofile.union_ms([(0, 10), (2, 3), (10, 12)]) \
        == pytest.approx(0.012)


def test_profile_prints_the_ports_records(capsys):
    tprofile.main(["--device", "cpu", "--hosts", "20", "--containers", "60",
                   "--warmup", "2", "--ticks", "3", "--delay-mode", "path"])
    out = capsys.readouterr().out
    assert "device read-backs per tick by site: admit_count 1.00" in out
    port = json.loads(out.strip().splitlines()[-1])["port"]
    assert port["syncs_per_tick"]["admit_count"] == 1.0
    assert port["syncs_per_tick"]["mig_enabled"] == 1.0
    assert port["admit_ms_per_candidate"] > 0
    assert 0 <= port["admitted_share"] <= 1
