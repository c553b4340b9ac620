"""Shared execution-option CLI surface (``repro.launch.execargs``).

Every launcher (``repro_torch.launch.sim`` / ``sweep`` / ``tune``) spells
the :class:`~repro_torch.core.types.ExecPlan` flags identically through
this one builder, and ``ExecPlan.from_args`` turns the parsed namespace
back into a plan, so ``--chunk 16 --slab 64 --delay-kernel off`` means the
same on every entry point.  Flags of fields the port does not have yet
(``--telescope``, ``--devices`` above 1, ``--procs``) parse and then
raise in ``ExecPlan``, naming their slice.

The kernel-selector flags default to ``None`` (= keep the ``SimConfig``
selectors) rather than ``'auto'``: an unset flag must not override a
config the caller built with explicit selectors.
"""
from __future__ import annotations

import argparse


def add_exec_args(ap: argparse.ArgumentParser, *, chunk: bool = True,
                  slab: bool = True, devices: bool = True,
                  overlap: bool = True, kernels: bool = True,
                  dist: bool = False):
    """Attach the ExecPlan flags to ``ap`` (one argument group).  The
    keyword switches drop flags that make no sense for a launcher
    (``launch.sim`` has no grid, so no ``--slab``); dropped flags stay
    absent from the namespace and ``ExecPlan.from_args`` takes the field
    defaults.  Returns the argument group."""
    g = ap.add_argument_group("execution (ExecPlan)")
    if chunk:
        g.add_argument("--chunk", type=int, default=None,
                       help="stream the horizon in chunks of this many "
                            "ticks with online summaries (O(state) memory; "
                            "default: stacked per-tick metrics)")
        g.add_argument("--telescope", action="store_true",
                       help="macro-tick engine (not ported yet: raises, "
                            "naming the telescoping slice)")
    if slab:
        g.add_argument("--slab", type=int, default=None,
                       help="with --chunk: gather the grid's results to the "
                            "host this many cells at a time (default: the "
                            "whole grid at once)")
    if devices:
        g.add_argument("--devices", type=int, default=None,
                       help="devices to run the grid on (the port runs on "
                            "one; more raises, naming the multi-process "
                            "fabric slice)")
    if overlap:
        g.add_argument("--no-overlap", action="store_true",
                       help="the JAX package's flag, taken for its "
                            "command lines: the port copies each slab's "
                            "results to the host synchronously either way")
    if kernels:
        g.add_argument("--delay-kernel", default=None,
                       choices=["auto", "on", "off"],
                       help="fw_minplus CUDA kernel for the 'fw' delay "
                            "refresh (auto: the kernel on a CUDA device, "
                            "the plain PyTorch version on the CPU; default: "
                            "keep the SimConfig selector)")
        g.add_argument("--waterfill-kernel", default=None,
                       choices=["auto", "on", "off"],
                       help="seg_waterfill CUDA kernel for the flow "
                            "allocation (same semantics)")
    if dist:
        g.add_argument("--procs", type=int, default=None,
                       help="worker processes (not ported yet: more than 1 "
                            "raises, naming the multi-process fabric slice)")
        g.add_argument("--devices-per-proc", type=int, default=None,
                       help="devices each worker process claims (same)")
    return g
