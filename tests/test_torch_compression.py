"""The port's int8 gradient compression (repro_torch.distributed.
compression) against the JAX package's, on the CPU.

Contracts: ``quantize_int8`` (q and scale), ``dequantize_int8`` and
``ErrorFeedback.apply`` over several steps equal JAX's bit for bit
(``torch.round`` and ``jnp.round`` both round half to even; the inputs
include exact halves and zeros); ``pod_compressed_mean`` returns the
gradients unchanged on a mesh without a ``pod`` axis, as JAX's does; the
train step refuses ``compress_pod_grads`` without one.  The mean over a
real pod group is held in ``tests/test_torch_mesh.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402


def inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((33, 17)) * 10.0 ** rng.uniform(-6, 3)
         ).astype(np.float32)
    # exact ties of the rounding: multiples of half the scale
    x[0, :6] = np.array([0.5, 1.5, -2.5, 3.5, 0.0, -0.0], np.float32) * (
        np.abs(x).max() / 127)
    return x


@pytest.mark.parametrize("seed", range(4))
def test_quantize_matches_jax_bit_for_bit(seed):
    import jax.numpy as jnp
    from repro.distributed import compression as jcomp
    x = inputs(seed)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.asarray(js).tobytes() == ts.numpy().tobytes()
    jd = np.asarray(jcomp.dequantize_int8(jq, js))
    td = tcomp.dequantize_int8(tq, ts).numpy()
    assert td.tobytes() == jd.tobytes()


def test_quantize_zeros_and_tiny():
    import jax.numpy as jnp
    from repro.distributed import compression as jcomp
    for x in (np.zeros((4, 4), np.float32),
              np.full((3,), 1e-30, np.float32)):
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)


def test_error_feedback_matches_jax_over_steps():
    import jax
    import jax.numpy as jnp
    from repro.distributed import compression as jcomp
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 2)}}

    def draw(scale):
        return jax.tree.map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))

    g0 = draw(1.0)
    jres = jcomp.ErrorFeedback.init(jax.tree.map(jnp.asarray, g0))
    tres = tcomp.ErrorFeedback.init(jax.tree.map(torch.from_numpy, g0))
    for step in range(4):
        g = draw(10.0 ** (step - 2))
        jg, jres = jcomp.ErrorFeedback.apply(jax.tree.map(jnp.asarray, g),
                                             jres)
        tg, tres = tcomp.ErrorFeedback.apply(
            jax.tree.map(torch.from_numpy, g), tres)
        for a, b in zip(jax.tree.leaves(tg), jax.tree.leaves(jg)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes(), step
        for a, b in zip(jax.tree.leaves(tres), jax.tree.leaves(jres)):
            assert a.numpy().tobytes() == np.asarray(b).tobytes(), step


def test_no_pod_axis_leaves_gradients_unchanged():
    grads = {"w": torch.randn(4, 3), "b": [torch.randn(2)]}
    assert tcomp.pod_compressed_mean(
        grads, ShapeMesh((2, 2), ("data", "model"))) is grads
    cfg = get_reduced("smollm_360m")
    with pytest.raises(ValueError, match="pod"):
        tstep.make_train_step(cfg, tstep.opt_mod.OptimizerConfig(),
                              tstep.StepConfig(compress_pod_grads=True))
    with pytest.raises(ValueError, match="pod"):
        tstep.make_grad_fn(cfg, tstep.StepConfig(compress_pod_grads=True),
                           mesh=ShapeMesh((2, 2), ("data", "model")))


def test_compressed_mean_of_one_member_is_the_round_trip():
    x = torch.from_numpy(inputs(9))
    q, s = tcomp.quantize_int8(x)
    assert torch.equal(tcomp.compressed_psum_mean(x, None),
                       tcomp.dequantize_int8(q, s))
