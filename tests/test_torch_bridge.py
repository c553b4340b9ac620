"""repro_torch.core.bridge (ML jobs -> DCSim containers) against the JAX
package's ``core/bridge.py``.

* ``workload_from_jobs``: every container array exactly equal to JAX's
  (the body is numpy from the seed in both), for the example's job mix
  and others, at its own capacity and a larger one, both packages given
  the JAX default ``gpu_speed_flops`` (197e12) explicitly;
* ``job_from_dryrun`` / ``jobs_from_results`` on a results JSON written
  here (the dry-run's ``experiments/dryrun_results.json`` is not in the
  repo): the same jobs, in the same order;
* ``examples/schedule_training_cluster.py``'s ``fallback_jobs()`` on its
  testbed (paper hosts, the Fig 3 fabric at bw 10000, horizon 220, 10
  containers a host) through ``run_sim`` for round, performance_first,
  jobgroup and netaware: final state and per-tick metrics leaf by leaf
  (integer leaves exactly, float leaves within rtol 1e-5 / atol 1e-4, as
  test_torch_engine.py holds the paper experiment) and the reports.
"""
import dataclasses
import functools
import importlib.util
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import SimConfig as JSimConfig  # noqa: E402
from repro.core import bridge as jbridge  # noqa: E402
from repro.core import (build_paper_hosts as jhosts,  # noqa: E402
                        build_paper_network as jnetwork,
                        get_policy as jpolicy, init_sim as jinit,
                        run_sim as jrun, summarize as jsummarize)
from repro_torch.core import (SimConfig, build_paper_hosts,  # noqa: E402
                              build_paper_network, get_policy, init_sim,
                              run_sim, summarize)
from repro_torch.core import bridge  # noqa: E402
from repro_torch.core.convert import assert_state_close  # noqa: E402

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "schedule_training_cluster.py")
POLICIES = ["round", "performance_first", "jobgroup", "netaware"]
# the JAX package's default work-unit clock (a TPU v5e's bf16 peak),
# passed to both packages: the port's default is the H100's
V5E_FLOPS = 197e12
RTOL, ATOL = 1e-5, 1e-4


@functools.lru_cache(maxsize=None)
def example_jobs():
    """``fallback_jobs()`` of the example (the JAX package's MLJobSpecs)."""
    spec = importlib.util.spec_from_file_location("schedule_training_cluster",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return tuple(mod.fallback_jobs())


def port_jobs(jobs):
    return [bridge.MLJobSpec(**dataclasses.asdict(j)) for j in jobs]


def example_cfg(cls):
    return cls(horizon=220, max_containers_per_host=10)


MIXES = {
    "example": lambda: example_jobs(),
    "one_long_job": lambda: (jbridge.MLJobSpec(
        "deepseek-v2-236b", "train_4k", 16, 40, 9e15, 3e11, 32.0),),
    "short_and_uneven": lambda: (
        jbridge.MLJobSpec("musicgen-large", "train_4k", 1, 3, 1e12, 1e6,
                          1.0),
        jbridge.MLJobSpec("paligemma-3b", "train_4k", 5, 25, 4e14, 2e10,
                          16.0),
        jbridge.MLJobSpec("olmoe-1b-7b", "train_4k", 3, 7, 8e13, 5e9, 8.0)),
}


@pytest.mark.parametrize("capacity", [None, 64])
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_workload_from_jobs_equals_jax(mix, seed, capacity):
    jobs = MIXES[mix]()
    want = jbridge.workload_from_jobs(jobs, example_cfg(JSimConfig),
                                      capacity=capacity, seed=seed,
                                      gpu_speed_flops=V5E_FLOPS)
    got = bridge.workload_from_jobs(port_jobs(jobs), example_cfg(SimConfig),
                                    capacity=capacity, seed=seed,
                                    gpu_speed_flops=V5E_FLOPS,
                                    device="cpu")
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        assert g.device.type == "cpu", name
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    n = sum(j.n_workers for j in jobs)
    assert int((got.job >= 0).sum()) == n
    assert got.req.shape[0] == (capacity or n)


DRYRUN_ROWS = [
    dict(arch="qwen2.5-3b", shape="train_4k", mesh="single", status="ok",
         flops=1.2e14, approx_bytes_per_device_gb=9.5),
    dict(arch="olmoe-1b-7b", shape="train_4k", mesh="single", status="ok",
         flops=6e13),
    dict(arch="deepseek-v2-236b", shape="train_4k", mesh="single",
         status="ok", flops=3e15, approx_bytes_per_device_gb=300.0),
    dict(arch="not-a-registered-arch", shape="train_4k", mesh="single",
         status="ok", flops=2e13, approx_bytes_per_device_gb=0.2),
    dict(arch="qwen2.5-3b", shape="prefill_32k", mesh="single",
         status="ok", flops=5e14),
    dict(arch="smollm-360m", shape="train_4k", mesh="multi_pod",
         status="ok", flops=1e13),
    dict(arch="mamba2-1.3b", shape="train_4k", mesh="single",
         status="oom"),
]


@pytest.mark.parametrize("archs", [None, ("olmoe-1b-7b",
                                          "not-a-registered-arch")])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_jobs_from_results_equal_jax(tmp_path, shape, archs):
    path = str(tmp_path / "dryrun_results.json")
    with open(path, "w") as f:
        json.dump(DRYRUN_ROWS, f)
    want = jbridge.jobs_from_results(path, shape=shape, archs=archs,
                                     n_workers=6, steps=10)
    got = bridge.jobs_from_results(path, shape=shape, archs=archs,
                                   n_workers=6, steps=10)
    assert [dataclasses.asdict(j) for j in got] == \
        [dataclasses.asdict(j) for j in want]
    assert len(got) == {("train_4k", None): 4, ("prefill_32k", None): 1,
                        ("train_4k", ("olmoe-1b-7b", "not-a-registered-arch"
                                      )): 2}.get((shape, archs), 0)


def test_job_from_dryrun_counts_active_parameters():
    row = DRYRUN_ROWS[2]
    job = bridge.job_from_dryrun(row, n_workers=4, steps=7)
    assert job == bridge.MLJobSpec(**dataclasses.asdict(
        jbridge.job_from_dryrun(row, n_workers=4, steps=7)))
    from repro_torch.configs import get_config
    assert job.coll_bytes_per_step == \
        4.0 * get_config("deepseek-v2-236b").active_param_count()
    assert job.mem_gb == 32.0       # clipped to [1, 32]
    assert bridge.job_from_dryrun(DRYRUN_ROWS[3]).coll_bytes_per_step \
        == 4.0e9


@functools.lru_cache(maxsize=None)
def jax_example_run(policy):
    cfg = example_cfg(JSimConfig)
    spec, net = jnetwork(cfg, bw=10000.0)
    conts = jbridge.workload_from_jobs(example_jobs(), cfg,
                                       gpu_speed_flops=V5E_FLOPS)
    final, metrics = jrun(jinit(jhosts(), conts, net), cfg, jpolicy(policy),
                          spec.n_hosts, spec.n_nodes, cfg.horizon)
    return (jax.device_get(final), jax.device_get(metrics),
            jsummarize(final, metrics))


@pytest.mark.parametrize("policy", POLICIES)
def test_example_jobs_run_as_in_jax(policy):
    jfinal, jmetrics, jrep = jax_example_run(policy)
    cfg = example_cfg(SimConfig)
    spec, net = build_paper_network(cfg, bw=10000.0, device="cpu")
    conts = bridge.workload_from_jobs(port_jobs(example_jobs()), cfg,
                                      gpu_speed_flops=V5E_FLOPS,
                                      device="cpu")
    final, metrics = run_sim(init_sim(build_paper_hosts(device="cpu"), conts,
                                      net),
                             cfg, get_policy(policy, device="cpu"),
                             spec.n_hosts, spec.n_nodes, cfg.horizon)
    assert_state_close(final, jfinal, RTOL, ATOL)
    assert_state_close(metrics, jmetrics, RTOL, ATOL)
    rep = summarize(final, metrics)
    assert rep["n_completed"] == jrep["n_completed"] > 0
    for k, v in jrep.items():
        if isinstance(v, float) and np.isfinite(v):
            np.testing.assert_allclose(rep[k], v, rtol=1e-4, err_msg=k)
