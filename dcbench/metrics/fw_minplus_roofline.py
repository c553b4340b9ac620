"""fw_minplus_roofline: the kernel's bound over its device time per call,
%.  The bound: 2 n^3 float32 operations at the call's n nodes
(dcbench/peaks.py) at the published FP32 peak; the device time: the
seconds in which the fw_panels and fw_tiles kernels of the traced unit
ran (the union of their intervals: a call's launches overlap under
programmatic dependent launch), over the wrapper's calls in it."""


def read(rd):
    from dcbench import peaks
    n = rd.shapes.get("fw_n")
    calls = rd.traced["calls"]["fw_minplus"]
    tr = rd.trace
    if tr is None or not n or not calls:
        return None
    dev_s = tr.device_union_s(lambda k: "fw_panels" in k or "fw_tiles" in k)
    if dev_s <= 0:
        return None
    return 100.0 * peaks.bound_s(peaks.fw_minplus_work(n)) / (dev_s / calls)
