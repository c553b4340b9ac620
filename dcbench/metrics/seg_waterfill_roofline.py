"""seg_waterfill_roofline: the kernel's bound over its device time per call,
%.  The bound: the call's input bytes read once and output bytes
written once at F flows of ``waterfill_hops`` link ids (4 where the
shapes give none) and E links (dcbench/peaks.py), at the published HBM
bandwidth; the device time: the waterfill kernels (the
one-launch ``waterfill_smem`` or the four-launch variant's
``csr_*``/``waterfill``) of the traced unit, the union of their
intervals, over the wrapper's calls."""


def read(rd):
    from dcbench import peaks
    F, E = rd.shapes.get("waterfill_F"), rd.shapes.get("waterfill_E")
    calls = rd.traced["calls"]["seg_waterfill"]
    tr = rd.trace
    if tr is None or not calls:
        return None
    dev_s = tr.device_union_s(lambda k: "waterfill" in k or "csr_" in k)
    if dev_s <= 0:
        return None
    hops = rd.shapes.get("waterfill_hops", 4)
    return 100.0 * peaks.bound_s(peaks.seg_waterfill_work(F, E, hops)) \
        / (dev_s / calls)
