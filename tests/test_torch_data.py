"""The port's data pipeline (repro_torch.data.pipeline) against the JAX
package's (repro.data.pipeline, pure numpy): every batch is the same pure
function of (seed, step), array for array, for each frontend and for a
token file; ``to_device`` keeps values and dtypes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

FRONTENDS = [dict(frontend="none"),
             dict(frontend="patch_embeds", n_prefix=8, d_model=16),
             dict(frontend="frame_embeds", d_model=16)]


def both(**kw):
    return jpipe.DataConfig(**kw), tpipe.DataConfig(**kw)


def assert_same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("front", FRONTENDS, ids=lambda f: f["frontend"])
def test_synthetic_batches_equal_jax(front):
    jcfg, tcfg = both(seq_len=24, global_batch=3, vocab=100, seed=7, **front)
    jd, td = jpipe.SyntheticLM(jcfg), tpipe.SyntheticLM(tcfg)
    for step in (0, 1, 5, 1000):
        assert_same_batch(td.batch_at(step), jd.batch_at(step))
    it_j, it_t = jd.iterate(3), td.iterate(3)
    for _ in range(3):
        assert_same_batch(next(it_t), next(it_j))


def test_batches_are_a_function_of_seed_and_step():
    _, tcfg = both(seq_len=16, global_batch=2, vocab=50, seed=1)
    d = tpipe.SyntheticLM(tcfg)
    a, b = d.batch_at(4), d.batch_at(4)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["tokens"], d.batch_at(5)["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 50


def test_file_dataset_equals_jax(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 500, 4001).astype(
        np.int32).tofile(path)
    jcfg, tcfg = both(seq_len=32, global_batch=4, vocab=500, seed=3)
    jd = jpipe.make_dataset(jcfg, str(path))
    td = tpipe.make_dataset(tcfg, str(path))
    assert isinstance(td, tpipe.FileDataset)
    assert td.n_windows == jd.n_windows == 125
    for step in (0, 2, 9):
        assert_same_batch(td.batch_at(step), jd.batch_at(step))
    assert isinstance(tpipe.make_dataset(tcfg), tpipe.SyntheticLM)


def test_to_device_keeps_values_and_dtypes():
    _, tcfg = both(seq_len=12, global_batch=2, vocab=64, seed=0,
                   frontend="patch_embeds", n_prefix=4, d_model=8)
    batch = tpipe.SyntheticLM(tcfg).batch_at(0)
    on = tpipe.to_device(batch, "cpu")
    for k, v in batch.items():
        assert on[k].dtype == torch.from_numpy(v).dtype, k
        np.testing.assert_array_equal(on[k].numpy(), v, err_msg=k)
    assert on["patch_embeds"].shape == (2, 4, 8)
    assert on["tokens"].shape == on["labels"].shape == (2, 8)
