"""The frozen work counts and peaks: each bound depends on the call's
input shapes alone (CPU, no card)."""
from types import SimpleNamespace

import pytest

from dcbench import harness, peaks
from dcbench.trace import Trace


def test_fw_minplus_bound_at_the_real_size():
    # 2 n^3 operations at n = 2402 at 67 TFLOP/s: 0.4137 ms, whatever the
    # kernel pads n to (2432 for 64-node tiles)
    w = peaks.fw_minplus_work(2402)
    assert w["flops"] == 2 * 2402 ** 3
    assert peaks.bound_s(w) == pytest.approx(2 * 2402 ** 3 / 67e12)
    assert peaks.bound_s(w) * 1e3 == pytest.approx(0.41370, abs=1e-4)
    assert peaks.bound_s(peaks.fw_minplus_work(2432)) \
        > peaks.bound_s(w)


def test_seg_waterfill_bound_at_the_real_size():
    w = peaks.seg_waterfill_work(12000, 2800)
    assert w["bytes"] == 12000 * (16 + 1 + 4 + 4) + 2800 * 8
    assert peaks.bound_s(w) == pytest.approx(w["bytes"] / 3.35e12)


@pytest.mark.parametrize("F,E", [(12000, 2800), (600, 28)])
def test_seg_waterfill_work_counts_each_link_id_of_a_path(F, E):
    four = peaks.seg_waterfill_work(F, E)
    assert four == peaks.seg_waterfill_work(F, E, hops=4)
    six = peaks.seg_waterfill_work(F, E, hops=6)
    assert six["bytes"] - four["bytes"] == 8 * F
    assert six["flops"] == four["flops"] == 0.0


@pytest.mark.parametrize("fn,args", [
    (peaks.fw_minplus_work, (2402,)), (peaks.fw_minplus_work, (26,)),
    (peaks.seg_waterfill_work, (12000, 2800)),
    (peaks.seg_waterfill_work, (600, 28))])
def test_bounds_depend_only_on_the_shapes(fn, args):
    a, b = fn(*args), fn(*args)
    assert a == b and peaks.bound_s(a) > 0
    bigger = fn(*(x * 2 for x in args))
    assert peaks.bound_s(bigger) > peaks.bound_s(a)


def reading(name, dev_ms, calls, shapes):
    """A reader's value over a synthetic trace: each call's fw kernels
    overlapping (dev_ms of wall time each), one waterfill kernel of
    dev_ms a call."""
    tr = Trace(window_s=1.0)
    t, ns = 0, int(dev_ms * 1e6)
    for _ in range(max(calls, 1)):
        tr.device += [(t, t + ns // 2, "(anonymous namespace)::fw_panels"),
                      (t + ns // 4, t + ns, "(anonymous namespace)::fw_tiles"),
                      (t, t + ns, "void waterfill_smem<4>(...)")]
        t += 2 * ns
    rd = SimpleNamespace(trace=tr, shapes=shapes,
                         traced={"calls": {"fw_minplus": calls,
                                           "seg_waterfill": calls}})
    spec = harness.load_cell("sim100-burst")
    return spec.readers[name].read(rd)


def test_roofline_readers_share_the_bound_out_of_the_time():
    shapes = {"fw_n": 2402, "waterfill_F": 12000, "waterfill_E": 2800}
    fw = reading("fw_minplus_roofline", 1.704, 2, shapes)
    assert fw == pytest.approx(100 * 0.41370 / 1.704, rel=1e-3)
    wf = reading("seg_waterfill_roofline", 0.1526, 1, shapes)
    assert 0 < wf < 0.1
    # nothing to read: no value, never a 0
    assert reading("fw_minplus_roofline", 1.7, 0, shapes) is None
    assert reading("fw_minplus_roofline", 1.7, 1,
                   dict(shapes, fw_n=None)) is None


def test_the_waterfill_reader_takes_the_paths_length():
    shapes = {"fw_n": 125, "waterfill_F": 3000, "waterfill_E": 200}
    four = reading("seg_waterfill_roofline", 0.05, 2, shapes)
    assert four == reading("seg_waterfill_roofline", 0.05, 2,
                           dict(shapes, waterfill_hops=4))
    six = reading("seg_waterfill_roofline", 0.05, 2,
                  dict(shapes, waterfill_hops=6))
    work = lambda h: peaks.seg_waterfill_work(3000, 200, h)["bytes"]
    assert six / four == pytest.approx(work(6) / work(4))
