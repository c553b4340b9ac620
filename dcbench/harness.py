"""The benchmark harness: one run of one cell of ``BENCHMARK.json``.

    python3 dcbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything a cell is made of is found by name: its configuration in the
file ``BENCHMARK.json`` gives it, the fabric its fleet names
(``topology``, ``spine_leaf`` where it names none) at
``dcbench/topologies/<topology>.py`` for the program and
``dcbench/reference/topologies/<topology>.py`` for the reference, its
traffic mix at ``dcbench/traffic/<traffic>.json``, the window driver
that mix names at ``dcbench/drivers/<driver>.py`` and each metric's
reader, end-to-end or per-layer, at ``dcbench/metrics/<metric>.py``.
A run builds the port's simulator kernels where the checkout has not
yet, builds the cell's inputs from the seed, warms the cell's own path,
measures a window of at least ``--seconds`` that closes at the first
boundary of the driver's unit after them, reads the device's peak
memory, checks what the window produced against the plain reference,
and prints one JSON line.  With ``--trace 1`` the window's first unit
is traced.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import re
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from dcbench import compare, program

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class RunError(Exception):
    """A run that cannot give a result: it prints no line and exits
    non-zero."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _module(path: Path, name: str):
    if not path.is_file():
        raise RunError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_topology(fleet: dict, root: Path = ROOT) -> SimpleNamespace:
    """The fabric ``fleet`` names: its ``name``, the program's side
    (``port``: ``host_switch``, ``build``, ``kernel_shapes``) and the
    reference's (``reference``: ``build_net``)."""
    name = fleet.get("topology", "spine_leaf")
    if not NAME.match(name):
        raise RunError(f"no topology {name!r}: not a name")
    bench = root / "dcbench"
    return SimpleNamespace(
        name=name,
        port=_module(bench / "topologies" / f"{name}.py",
                     f"dcbench_topology_{name}"),
        reference=_module(bench / "reference" / "topologies" / f"{name}.py",
                          f"dcbench_reference_topology_{name}"))


def load_cell(name: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``name``: its manifest entry, configuration, fabric,
    traffic, driver class and per-layer metric readers, all found by
    name."""
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(root / "dcbench" / "traffic"
                        / f"{cell['traffic']}.json")
    driver = _module(root / "dcbench" / "drivers"
                     / f"{traffic['driver']}.py",
                     f"dcbench_driver_{traffic['driver']}").Driver
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m for m in man["per_layer"]
                 if name in m.get("workloads", [name])]
    readers = {m["name"]: _module(root / "dcbench" / "metrics"
                                  / f"{m['name']}.py",
                                  f"dcbench_metric_{m['name']}")
               for m in e2e + per_layer}
    sim = dict(config["sim"])
    sim.update(traffic.get("sim", {}))
    return SimpleNamespace(cell=cell, config=config,
                           topology=load_topology(config["fleet"], root),
                           traffic=traffic, driver=driver, end_to_end=e2e,
                           per_layer=per_layer, readers=readers, sim=sim,
                           chips=cell["chips"])


def context(spec: SimpleNamespace, seed: int, device) -> SimpleNamespace:
    """What a cell's driver is built from: its configuration, fabric,
    traffic and merged ``sim`` settings, the run's seed and device."""
    return SimpleNamespace(config=spec.config, topology=spec.topology,
                           traffic=spec.traffic, sim=spec.sim,
                           seed=int(seed), device=device)


def measure(unit, seconds: float, clock=time.perf_counter,
            done=lambda: True) -> tuple:
    """Units back to back until ``seconds`` have passed and ``done()``
    holds, the last one finished: (work done, wall seconds, each unit's
    seconds)."""
    t0 = t = clock()
    work, times = 0, []
    while True:
        work += unit()
        now = clock()
        times.append(now - t)
        t = now
        if now - t0 >= seconds and done():
            return work, now - t0, times


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port's run may not
    load, compared whole (``repro_torch`` is not ``repro``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device=None, root: Path = ROOT, t_start: float | None = None,
             clock=time.perf_counter) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``device`` None means the card, which must be there."""
    import torch

    t_start = clock() if t_start is None else t_start
    spec = load_cell(name, root)
    try:
        kernels = program.port().kernels
    except ImportError as e:
        raise RunError(f"the program cannot be imported: {e}") from e
    t_imported = clock()
    if device is None:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < spec.chips:
            raise RunError(f"{name} needs {spec.chips} CUDA devices, "
                           f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_cuda \
        else (lambda: None)
    ctx = context(spec, seed, device)
    compiled = program.build_kernels(spec.sim) if on_cuda else []
    t_built = clock()
    driver = spec.driver(ctx)
    driver.setup()
    sync()
    t_state = clock()
    driver.warm()
    sync()
    gc.collect()
    mem_setup = 0
    if on_cuda:
        mem_setup = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_window = clock()
    setup_s = t_window - t_start

    traces = []
    if trace:
        from dcbench import trace as tracing
        first = {}

        def unit():
            if traces:
                return driver.unit()
            before, c0 = dict(kernels.LAUNCHES), driver.counters()
            with tracing.traced(device, program.port().engine, traces):
                n = driver.unit()
            first.update(work=n, ticks=driver.counters()["ticks"]
                         - c0["ticks"],
                         calls={k: kernels.LAUNCHES[k] - before[k]
                                for k in before})
            return n
    else:
        unit, first = driver.unit, None
    _, wall, unit_s = measure(unit, seconds, clock,
                              done=lambda: not trace or bool(traces))
    sync()
    counters = driver.counters()
    mem_window = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    mem_peak = max(mem_setup, mem_window)
    found = forbidden_modules()
    if found:
        raise RunError("modules that the port may not load are loaded: "
                       + ", ".join(found))
    driver.close()
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    readings = driver.check()
    correct, failed, checks = compare.judge(readings,
                                            spec.traffic["limits"])

    rd = SimpleNamespace(setup_s=setup_s, window_s=wall, counters=counters,
                         trace=traces[0] if traces else None, traced=first,
                         shapes=driver.shapes(), mem_window_bytes=mem_window)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        v = spec.readers[m["name"]].read(rd)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
           "count": spec.chips, "memory_peak_bytes": int(mem_peak)}
    out = {"correct": correct, "attempted": len(readings), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        tr = traces[0]
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown()
    out["units"] = {"unit": driver.unit_name, "seconds": unit_s,
                    "answers": driver.n_answers}
    # set-up by part: the nvcc build (a checkout's first run only) apart
    out["setup"] = {"imports_s": t_imported - t_start,
                    "build_s": t_built - t_imported, "compiled": compiled,
                    "state_s": t_state - t_built,
                    "warm_s": t_window - t_state}
    out["checks"] = checks
    return out

