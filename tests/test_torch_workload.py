"""repro_torch.core.workload against repro.core.workload: the same
(cfg, seed) gives identical arrays in both packages."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import SimConfig as JaxSimConfig  # noqa: E402
from repro.core import workload as jwl  # noqa: E402
from repro_torch.core import SimConfig  # noqa: E402
from repro_torch.core import workload as twl  # noqa: E402


@pytest.mark.parametrize("gen", ["paper_workload", "trace_workload"])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_workload_arrays_identical(gen, seed):
    kw = dict(n_jobs=30, n_tasks=90, n_containers=120)
    ref = jax.device_get(getattr(jwl, gen)(JaxSimConfig(**kw), seed=seed))
    got = getattr(twl, gen)(SimConfig(**kw), seed=seed, device="cpu")
    assert ref._fields == got._fields
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_workload_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twl.paper_workload(SimConfig())
