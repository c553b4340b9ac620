"""The yardstick of the roofline readers: an NVIDIA H100 SXM's published
peaks (NVIDIA's data sheet, dense rates, at the full 700 W power limit)
and the work of each of the simulator's kernels, counted from a call's
input shapes alone, whatever implements the kernel (no padding, tiling
or instruction choice enters).

A bound is the least time the chip could take a call: the larger of the
call's operations over the peak rate of their type and its bytes over
the memory bandwidth.  It replaces, for the benchmark, the issue-rate
bound of 2 n_pad^3 FP32 instructions that the port's bring-up records
state for ``fw_minplus``: that one counted the kernel's own padding.
"""
from __future__ import annotations

FP32_FLOPS = 67e12      # float32 outside the tensor cores
HBM_BYTES = 3.35e12     # HBM3 bytes a second


def fw_minplus_work(n: int) -> dict:
    """All-pairs shortest paths over an ``n``-node adjacency: an add and
    a min for each of the n^3 relaxations; the n x n float32 matrix read
    once and written once."""
    return {"flops": 2.0 * n ** 3, "bytes": 2.0 * 4 * n * n}


def seg_waterfill_work(F: int, E: int, hops: int = 4) -> dict:
    """Max-min-fair allocation of ``F`` flows over ``E`` links: each input
    byte read once (the flows' ``hops`` int32 link ids, their bool active
    flags and float32 Mathis caps, the links' float32 capacities) and each
    output byte written once (float32 rates and link loads).  Its
    arithmetic is a few operations a byte, so bytes bound it."""
    return {"flops": 0.0,
            "bytes": float(F * (hops * 4 + 1 + 4) + E * 4 + F * 4 + E * 4)}


def bound_s(work: dict) -> float:
    return max(work["flops"] / FP32_FLOPS, work["bytes"] / HBM_BYTES)
