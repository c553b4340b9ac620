"""The port's dry run (repro_torch.launch.dryrun) against the JAX
package's ``launch/dryrun.py``, on the CPU, with no device allocation.

Contracts:
* every one of the 80 cells (10 archs x 4 shapes x 2 meshes) is run or
  skipped, and skipped with the reason, as JAX's ``cell_is_runnable``
  says;
* for reduced configs at the production shapes, ``run_cell`` gives JAX's
  ``n_devices`` and ``model_flops``, and JAX's row keys;
* ``argument_size_bytes`` equals JAX's ``memory_analysis()
  .argument_size_in_bytes`` for reduced train, prefill and decode cells
  at a (2, 2) mesh and small shapes (JAX lowers and compiles its deploy
  program in a subprocess with 4 host devices) — a decode cell's less 4
  bytes: JAX's cache length is a device int32, the port's a host int;
* on a homogeneous stack the full-depth count equals the two-probe
  extrapolation; on a hybrid one whose depth is no multiple of its
  attention period it does not (JAX's extrapolation counts a fraction of
  an attention application: ROADMAP Queue 3);
* a traced cell leaves no tensor off ``meta``; a shape-only collective
  given a tensor off ``meta`` raises;
* ``main`` writes rows that both packages' ``jobs_from_results`` read.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import (ARCH_IDS, SHAPES,  # noqa: E402
                                 cell_is_runnable, get_config, get_reduced)
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed.collectives import ShapeGroup  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
JAX_ROW_KEYS = {"arch", "shape", "mesh", "status", "n_devices", "lower_s",
                "compile_s", "flops", "hbm_bytes", "coll_bytes_per_dev",
                "coll_breakdown", "t_compute", "t_memory", "t_collective",
                "bottleneck", "model_flops", "useful_ratio",
                "memory_analysis", "approx_bytes_per_device_gb"}
MEM_KEYS = {"argument_size_bytes", "output_size_bytes", "temp_size_bytes",
            "generated_code_size_bytes"}
MESH22 = ((2, 2), ("data", "model"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_statuses_match_jax(arch):
    """The 8 cells of ``arch``: runnable as JAX's ``cell_is_runnable``
    says; a skipped cell's row carries JAX's reason (and traces
    nothing)."""
    from repro.configs import get_config as jget_config
    from repro.models.config import SHAPES as JSHAPES
    from repro.models.config import cell_is_runnable as jrunnable
    for name, shape in SHAPES.items():
        want = jrunnable(jget_config(arch), JSHAPES[name])
        assert cell_is_runnable(get_config(arch), shape) == want, name
        if want[0]:
            continue
        for multi in (False, True):
            row = dryrun.run_cell(arch, name, multi)
            assert row == {"arch": arch, "shape": name,
                           "mesh": "multi" if multi else "single",
                           "status": "skipped", "reason": want[1]}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_cell_gives_jax_devices_and_model_flops(arch):
    """Reduced configs at production shapes on both meshes."""
    from repro.configs import get_reduced as jget_reduced
    from repro.launch import roofline as jroof
    from repro.models.config import SHAPES as JSHAPES
    for name, multi in (("train_4k", False), ("decode_32k", True)):
        row = dryrun.run_cell(arch, name, multi, cfg=get_reduced(arch))
        assert row["status"] == "ok"
        assert set(row) == JAX_ROW_KEYS | {"kernels", "flops_by_dtype"}
        assert set(row["memory_analysis"]) == MEM_KEYS
        assert row["n_devices"] == (512 if multi else 256)
        assert row["model_flops"] == jroof.model_flops_for(
            jget_reduced(arch), JSHAPES[name])
        assert row["compile_s"] == 0.0 and row["flops"] > 0
        assert 0 < row["useful_ratio"] <= 1


JAX_ARGS = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
assert len(jax.devices()) == 4      # the backend starts before dryrun's flag
from repro.configs import get_reduced
from repro.launch import dryrun as jdry
from repro.launch.mesh import compat_mesh
from repro.models.config import ShapeSpec
out = {}
for arch, kind, S, B in json.loads(sys.argv[1]):
    shape = ShapeSpec("t", S, B, kind)
    mesh = compat_mesh((2, 2), ("data", "model"))
    compiled = jdry.lower_cell(get_reduced(arch), shape, mesh).compile()
    out[f"{arch}/{kind}"] = int(
        compiled.memory_analysis().argument_size_in_bytes)
print(json.dumps(out))
"""
ARG_CELLS = [("olmoe_1b_7b", "train", 32, 8), ("smollm_360m", "train", 32, 8),
             ("zamba2_1_2b", "prefill", 32, 8),
             ("deepseek_v2_236b", "prefill", 32, 8),
             ("smollm_360m", "decode", 32, 8), ("zamba2_1_2b", "decode", 64, 4),
             ("deepseek_v2_236b", "decode", 32, 8)]


def test_argument_bytes_match_jax():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_ARGS,
                           json.dumps(ARG_CELLS)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for arch, kind, S, B in ARG_CELLS:
        row = dryrun.run_cell(arch, "t", False, cfg=get_reduced(arch),
                              impl="ref", shape=ShapeSpec("t", S, B, kind),
                              mesh=ShapeMesh(*MESH22))
        got = row["memory_analysis"]["argument_size_bytes"]
        clen = 4 if kind == "decode" else 0
        assert got == want[f"{arch}/{kind}"] - clen, (arch, kind)


@pytest.mark.parametrize("arch,kind", [("smollm_360m", "train"),
                                       ("olmoe_1b_7b", "prefill"),
                                       ("qwen2_5_3b", "decode")])
def test_full_depth_count_equals_probe_extrapolation(arch, kind):
    """A homogeneous stack's cost is affine in its depth: the full-depth
    count equals JAX's two-probe extrapolation (FLOPs, bytes and every
    collective)."""
    cfg = dryrun.cell_config(dataclasses.replace(get_reduced(arch),
                                                 n_layers=7))
    shape = ShapeSpec("t", 32, 8, kind)
    mesh = ShapeMesh(*MESH22)
    full = dryrun.trace_cell(cfg, shape, mesh)[0].raw_costs()
    probe = dryrun.probe_costs(cfg, shape, mesh)
    assert dryrun.probe_depths(cfg) == (2, 4)
    assert probe.flops == pytest.approx(full["flops"], rel=1e-12)
    assert probe.hbm_bytes == pytest.approx(full["hbm_bytes"], rel=1e-12)
    assert probe.coll_bytes == pytest.approx(full["coll_bytes"], rel=1e-12)
    assert set(probe.coll_breakdown) == set(full["coll_breakdown"])
    for k, v in full["coll_breakdown"].items():
        assert probe.coll_breakdown[k] == pytest.approx(v, rel=1e-12), k


def test_probe_extrapolation_misses_a_hybrid_stack():
    """JAX's probes for the hybrid family (attn_every and twice it)
    extrapolate the shared attention linearly in depth, where the stack
    applies it n_layers // attn_every times: reduced zamba2 (attn_every
    2) probed at 2 and 4 layers (one and two applications) and
    extrapolated to 5 counts two and a half, where the stack applies it
    twice.  The full-depth count is the port's row."""
    cfg = dryrun.cell_config(dataclasses.replace(get_reduced("zamba2_1_2b"),
                                                 n_layers=5))
    shape = ShapeSpec("t", 32, 8, "prefill")
    mesh = ShapeMesh(*MESH22)
    assert dryrun.probe_depths(cfg) == (2, 4)
    full = dryrun.trace_cell(cfg, shape, mesh)[0]
    probe = dryrun.probe_costs(cfg, shape, mesh)
    assert full.kernels == {"ssd_scan": 5, "flash_attention": 2}
    one_app = dataclasses.replace(cfg, n_layers=2)
    two_apps = dataclasses.replace(cfg, n_layers=4)
    per_two = (dryrun.trace_cell(two_apps, shape, mesh)[0].flops
               - dryrun.trace_cell(one_app, shape, mesh)[0].flops)
    # the extrapolation adds half of (two ssd layers + one application)
    # for the fifth layer, where the stack adds one ssd layer
    ssd_layer = (dryrun.trace_cell(dataclasses.replace(cfg, n_layers=3),
                                   shape, mesh)[0].flops
                 - dryrun.trace_cell(one_app, shape, mesh)[0].flops)
    assert probe.flops - full.flops == pytest.approx(
        per_two / 2 - ssd_layer, rel=1e-12)
    assert probe.flops > full.flops


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_traced_cell_stays_on_meta(kind):
    """Every input and output of a traced cell lies on meta (and the
    counter, which raises on any op that makes a tensor elsewhere, ran
    the whole step)."""
    cfg = dryrun.cell_config(get_reduced("zamba2_1_2b"))
    shape = ShapeSpec("t", 64, 4, kind)
    mesh = ShapeMesh(*MESH22, rank=3)
    step, args, _ = dryrun.cell_program(cfg, shape, mesh)
    from repro_torch.launch.roofline import CostCounter
    with CostCounter(args) as cc:
        out = step(*args)
    leaves = _tensors(args) + _tensors(out)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    assert cc.records and cc.peak_bytes > cc.argument_bytes > 0
    want = {"train": {"ssd_scan": 8, "flash_attention": 4},
            "prefill": {"ssd_scan": 4, "flash_attention": 2},
            "decode": {}}[kind]
    assert cc.kernels == want


def test_shape_only_collectives_take_meta_only():
    g = ShapeGroup(4, 1)
    for fn in (lambda x: coll.all_reduce_sum(x, g),
               lambda x: coll.all_gather(x, 1, g),
               lambda x: coll.all_to_all(x, g),
               lambda x: coll.gather(x, 0, g)):
        with pytest.raises(ValueError, match="meta"):
            fn(torch.ones(4, 3))
    x = torch.empty((4, 3), device="meta")
    with coll.recording() as recs:
        assert coll.all_reduce_sum(x, g).shape == (4, 3)
        assert coll.all_gather(x, 1, g).shape == (4, 12)
        assert coll.all_to_all(x, g).shape == (4, 3)
        assert coll.all_reduce_sum(x, ShapeGroup(1, 0)).shape == (4, 3)
    assert recs == [("all-reduce", 48, 4), ("all-gather", 192, 4),
                    ("all-to-all", 48, 4)]
    mesh = ShapeMesh((2, 16, 16), ("pod", "data", "model"), rank=300)
    assert mesh.get_coordinate() == (1, 2, 12)
    from repro_torch.launch.mesh import axis_group
    assert axis_group(mesh, ("pod", "data")) == ShapeGroup(32, 18)
    assert axis_group(mesh, "model") == ShapeGroup(16, 12)


def test_main_writes_rows_both_bridges_read(tmp_path):
    """``main`` on a runnable and a skipped cell, both meshes: four rows
    with JAX's keys; the ok rows' jobs from both packages'
    ``jobs_from_results`` agree."""
    from repro.core import bridge as jbridge
    from repro_torch.core import bridge
    out = str(tmp_path / "rows.json")
    for arch in ("mamba2-1.3b", "smollm-360m"):
        dryrun.main(["--arch", arch, "--shape", "long_500k", "--mesh",
                     "both", "--out", out])
    with open(out) as f:
        rows = json.load(f)
    assert [(r["arch"], r["mesh"], r["status"]) for r in rows] == [
        ("mamba2-1.3b", "single", "ok"), ("mamba2-1.3b", "multi", "ok"),
        ("smollm-360m", "single", "skipped"),
        ("smollm-360m", "multi", "skipped")]
    assert JAX_ROW_KEYS <= set(rows[0])
    got = bridge.jobs_from_results(out, shape="long_500k")
    want = jbridge.jobs_from_results(out, shape="long_500k")
    assert len(got) == 1 and [dataclasses.asdict(j) for j in got] == [
        dataclasses.asdict(j) for j in want]
    assert got[0].flops_per_step == rows[0]["flops"]
    assert np.isfinite(rows[0]["t_memory"]) and rows[0]["t_memory"] > 0
