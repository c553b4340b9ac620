"""repro_torch.distributed against repro.distributed: slab checkpoints
written by either package restore in the other leaf for leaf, and the
fault-tolerance state machines give the JAX module's answers on the same
clock and step times."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.distributed import fault  # noqa: E402


def state(rng):
    """A nested dict as the sweep fabric and a trainer checkpoint them:
    keys out of sorted order, f32/i32/i64/f64/bool leaves, a 0-d leaf."""
    return {
        "summary": {"n_ticks": rng.integers(0, 9, (5,)).astype(np.int64),
                    "sum_util_var": rng.normal(size=(5,))},
        "finals": {"leaf_010": rng.normal(size=(5, 3)).astype(np.float32),
                   "leaf_002": rng.integers(-4, 4, (5,)).astype(np.int32),
                   "leaf_001": rng.random((5, 2)) < 0.5},
        "step": np.asarray(7, np.int32),
        "params": [rng.normal(size=(2, 2)).astype(np.float32),
                   rng.normal(size=(3,)).astype(np.float32)],
    }


def assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}/{i}")
    else:
        x = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        y = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert np.array_equal(x, y), path


def test_checkpoints_cross_between_packages(tmp_path):
    from repro.distributed import checkpoint as jckpt
    rng = np.random.default_rng(0)
    s = state(rng)
    like = {k: v for k, v in state(np.random.default_rng(1)).items()}
    # JAX writes, the port reads (numpy leaves)
    jckpt.save_checkpoint(str(tmp_path / "j"), s, 3)
    got, step = ckpt.restore_checkpoint(str(tmp_path / "j"), like)
    assert step == 3
    assert_same(s, got)
    # the port writes torch and numpy leaves, JAX reads
    mixed = dict(s, params=[torch.from_numpy(p) for p in s["params"]])
    ckpt.save_checkpoint(str(tmp_path / "t"), mixed, 11)
    got, step = jckpt.restore_checkpoint(str(tmp_path / "t"), like)
    assert step == 11
    assert_same(s, got)
    # the same files and manifests either way
    jckpt.save_checkpoint(str(tmp_path / "j2"), mixed["finals"], 1)
    ckpt.save_checkpoint(str(tmp_path / "t2"), mixed["finals"], 1)
    for name in ("manifest.json",):
        assert ((tmp_path / "j2" / name).read_text()
                == (tmp_path / "t2" / name).read_text())
    # a torch-tensor template restores torch tensors; a missing leaf and
    # a wrong shape are loud
    tlike = {"params": [torch.zeros(2, 2), torch.zeros(3)]}
    got, _ = ckpt.restore_checkpoint(str(tmp_path / "t"), tlike)
    assert all(isinstance(p, torch.Tensor) for p in got["params"])
    assert_same(mixed["params"], got["params"])
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore_checkpoint(str(tmp_path / "t"), {"nope": np.zeros(1)})
    with pytest.raises(ValueError, match="checkpoint shape"):
        ckpt.restore_checkpoint(str(tmp_path / "t"),
                                {"step": np.zeros((2,), np.int32)})
    # latest_step_dir agrees with the JAX package's
    for n in (2, 10, 9):
        (tmp_path / "run" / f"step_{n}").mkdir(parents=True)
    assert (ckpt.latest_step_dir(str(tmp_path / "run"))
            == jckpt.latest_step_dir(str(tmp_path / "run"))
            == str(tmp_path / "run" / "step_10"))
    assert ckpt.latest_step_dir(str(tmp_path / "none")) is None


def test_fault_machines_match_jax():
    from repro.distributed import fault as jfault
    t = [0.0]
    clock = lambda: t[0]
    workers = [f"pod{p}:{i}" for p in range(2) for i in range(3)]
    rng = np.random.default_rng(5)
    beats = [(float(now), [w for w in workers if rng.random() < 0.6])
             for now in np.cumsum(rng.uniform(1.0, 40.0, 30))]
    answers = []
    for mod in (fault, jfault):
        t[0] = 0.0
        cfg = mod.FaultConfig(suspect_after_s=30, dead_after_s=90)
        mon = mod.HeartbeatMonitor(workers, cfg, clock=clock)
        out = []
        for now, alive in beats:
            t[0] = now
            for w in alive:
                mon.beat(w)
            t[0] = now + 35.0
            out.append(([mon.status(w) for w in workers],
                        mon.dead_workers(), mon.all_healthy(),
                        dataclasses_tuple(mod.plan_recovery(mon, 2, 3))))
        t[0] = 10_000.0                   # everyone lost: elastic downsize
        out.append(dataclasses_tuple(mod.plan_recovery(mon, 2, 3)))
        det = mod.StragglerDetector(mod.FaultConfig(straggler_factor=2.0,
                                                    straggler_window=7))
        srng = np.random.default_rng(9)
        for step in range(25):
            for w in ("proc0", "proc1", "proc2"):
                slow = 4.0 if (w == "proc2" and step > 12) else 1.0
                det.record(w, float(srng.uniform(0.8, 1.2)) * slow)
            out.append((det.stragglers(), det.median_step()))
        answers.append(out)
    assert answers[0] == answers[1]
    assert answers[0][-1][0] == ["proc2"]
    assert answers[0][30][0] == "elastic_downsize"


def dataclasses_tuple(plan):
    return (plan.action, plan.reason, plan.lost_workers, plan.new_multi_pod)
