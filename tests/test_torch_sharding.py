"""The port's sharding rules (repro_torch.models.sharding,
repro_torch.launch.mesh) against the JAX package's, with no devices: the
production mesh shapes (16x16, 2x16x16) as a shape-only mesh on the
port's side and ``tests/test_sharding.py``'s ``FakeMesh`` on JAX's, the
parameter and cache trees as shapes (the port's on the ``meta`` device,
JAX's through ``jax.eval_shape``).

Contracts: ``param_specs``, ``cache_specs`` (at both decode shapes) and
``batch_specs`` equal JAX's leaf for leaf for all ten architectures on
both mesh shapes; ``cell_is_runnable`` answers as JAX's;
``_sp_mode`` decides as JAX's does; ``to_placements`` maps a spec to
DTensor placements; ``constrain`` is a no-op on one device.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import (ARCH_IDS, SHAPES,  # noqa: E402
                                 cell_is_runnable, get_config)
from repro_torch.launch.mesh import (ShapeMesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402


class FakeMesh:
    """The JAX tests' stand-in with a mesh shape (no devices needed)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = int(np.prod(list(self.shape.values())))


def meshes(multi_pod):
    port = make_production_mesh(multi_pod=multi_pod)
    return port, FakeMesh(zip(port.mesh_dim_names, port.shape))


def jax_specs(tree):
    import jax
    from jax.sharding import PartitionSpec as P
    return [tuple(s) for s in
            jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))]


def port_specs(tree):
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in port_specs(tree[k])]
    if isinstance(tree, shd.P):
        return [tuple(tree)]
    return [s for t in tree for s in port_specs(t)]


@functools.lru_cache(maxsize=None)
def jax_param_shapes(arch):
    import jax
    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtr
    return jax.eval_shape(lambda: jtr.init_params(jget_config(arch),
                                                  jax.random.PRNGKey(0)))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, multi_pod):
    import jax
    from repro.configs import get_config as jget_config
    from repro.models import sharding as jshd
    mesh, fake = meshes(multi_pod)
    want = jshd.param_specs(jget_config(arch), jax_param_shapes(arch), fake)
    cfg = get_config(arch)
    shapes = ttr.init_params(cfg, device="meta", masters=True)
    got = shd.param_specs(cfg, shapes, mesh)
    jleaves = jax.tree_util.tree_flatten(jax_param_shapes(arch))[0]
    tleaves = [shapes_leaf for shapes_leaf in _leaves(shapes)]
    assert [tuple(a.shape) for a in jleaves] == [tuple(t.shape)
                                                 for t in tleaves]
    assert port_specs(got) == jax_specs(want)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_match_jax(arch):
    import jax
    from repro.configs import get_config as jget_config
    from repro.models import sharding as jshd
    from repro.models import transformer as jtr
    from repro.models.config import SHAPES as JSHAPES
    from repro.models.config import cell_is_runnable as jcell_is_runnable
    jcfg, cfg = jget_config(arch), get_config(arch)
    for multi_pod in (False, True):
        mesh, fake = meshes(multi_pod)
        for name, shape in SHAPES.items():
            jshape = JSHAPES[name]
            runnable = cell_is_runnable(cfg, shape)
            assert runnable == jcell_is_runnable(jcfg, jshape), name
            if not runnable[0]:
                continue
            got = shd.batch_specs(cfg, shape, mesh)
            want = jshd.batch_specs(jcfg, jshape, fake)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, (name, multi_pod)
            if shape.kind != "decode":
                continue
            jcache = jax.eval_shape(lambda: jtr.init_cache(
                jcfg, jshape.global_batch, jshape.seq_len))
            cache = ttr.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   device="meta")
            assert [tuple(a.shape) for a in jax.tree.leaves(jcache)] == [
                tuple(t.shape) for t in _leaves(cache)]
            assert port_specs(shd.cache_specs(
                cfg, cache, mesh, shape.global_batch)) == jax_specs(
                jshd.cache_specs(jcfg, jcache, fake, jshape.global_batch))


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_jax(arch, shape_name):
    """The decode cache's spec tree of every arch at both decode shapes
    (long_500k too where the dry run skips the cell) on both production
    meshes equals JAX's, leaf for leaf."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.models import sharding as jshd
    from repro.models import transformer as jtr
    jcfg, cfg = jget_config(arch), get_config(arch)
    shape = SHAPES[shape_name]
    B, T = shape.global_batch, shape.seq_len
    jcache = jax.eval_shape(lambda: jtr.init_cache(jcfg, B, T))
    cache = ttr.init_cache(cfg, B, T, device="meta")
    for multi_pod in (False, True):
        mesh, fake = meshes(multi_pod)
        assert port_specs(shd.cache_specs(cfg, cache, mesh, B)) == \
            jax_specs(jshd.cache_specs(jcfg, jcache, fake, B)), multi_pod


def test_sp_mode_matches_jax():
    import dataclasses
    from repro.configs import get_reduced as jget_reduced
    from repro.models import transformer as jtr
    from repro_torch.configs import get_reduced
    for mode in ("off", "attn", "full"):
        jcfg = dataclasses.replace(jget_reduced("smollm_360m"),
                                   seq_parallel=mode)
        cfg = dataclasses.replace(get_reduced("smollm_360m"),
                                  seq_parallel=mode)
        for shape, axes in (((1, 1), ("data", "model")),
                            ((2, 2), ("data", "model")),
                            ((4, 1), ("data", "model")),
                            ((2, 1, 2), ("pod", "data", "model")),
                            ((16, 16), ("data", "model"))):
            mesh = ShapeMesh(shape, axes)
            fake = FakeMesh(zip(axes, shape))
            for S in (32, 33, 2048):
                for decode in (False, True):
                    assert ttr._sp_mode(cfg, mesh, S, decode) == \
                        jtr._sp_mode(jcfg, fake, S, decode), \
                        (mode, shape, S, decode)
        assert ttr._sp_mode(cfg, None, 32, False) == "off"


def test_production_meshes_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.shape, one.mesh_dim_names) == ((16, 16), ("data", "model"))
    assert (two.shape, two.mesh_dim_names, two.size()) == (
        (2, 16, 16), ("pod", "data", "model"), 512)
    assert shd.data_axes(one) == ("data",)
    assert shd.data_axes(two) == ("pod", "data")
    assert shd.to_placements(shd.P(("pod", "data"), None), two) == [
        Shard(0), Shard(0), Replicate()]
    assert shd.to_placements(shd.P(None, "model", "data"), one) == [
        Shard(2), Shard(1)]
    assert shd.to_placements(shd.P(), one) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="mesh order"):
        shd.to_placements(shd.P(("data", "pod")), two)
    # a rank's slices: rank (pod 1, data 3, model 5) of a [32, 64] leaf
    coord = {"pod": 1, "data": 3, "model": 5}
    assert shd.shard_slices(shd.P(("pod", "data"), "model"), (64, 32), two,
                            coord) == (slice(38, 40), slice(10, 12))
    assert shd.replica_axes(shd.P(None, "model"), two) == ("pod", "data")


def test_constrain_is_a_no_op_on_one_device():
    x = torch.ones(2, 3, 4)
    assert shd.constrain(x, None, shd.P("data", "model", None)) is x
    assert shd.constrain(x, ShapeMesh((1, 1), ("data", "model")),
                         shd.P("data", "model", None)) is x
    mesh = ShapeMesh((2, 2), ("data", "model"))
    assert shd.constrain(x, mesh, shd.P("data", None, None)) is x
    with pytest.raises(NotImplementedError):
        shd.constrain(x, mesh, shd.P("data", "model", None))
