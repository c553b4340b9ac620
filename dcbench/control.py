"""The control of a cell's comparison: the plain reference put in the
program's place, computed in bfloat16 where the configuration states
float32 (the delay refresh's shortest paths and the flow allocation's
rates), and judged by the same numbers and limits as the program.

    python3 dcbench/control.py --workload sim100-burst --seeds 1,2,3

Builds each seed's inputs as a run of the cell does, runs the reference
in float32 and in bfloat16 over them, and prints one JSON line a seed
with the compared numbers of the bfloat16 run and whether the
cell's limits pass it (they must not).  For a grid cell each compared
cell of the seed's first grid is read.  On the card where the cell's
reference runs there; ``--device cpu`` reads it on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dcbench import compare, harness  # noqa: E402


def control_readings(name: str, seed: int, device, root=harness.ROOT,
                     grids: int = 1) -> list:
    """The control's numbers over the inputs of ``seed``: one reading for
    an episode cell, one for each compared cell of the first ``grids``
    grids of a grid cell."""
    import torch
    spec = harness.load_cell(name, root)
    drv = spec.driver(harness.context(spec, seed, torch.device(device)))
    drv.build_inputs()
    if spec.traffic["driver"] == "grid":
        drv.grids = [(g, None, None) for g in range(grids)]
        pairs = [(drv.reference(*i), drv.reference(*i, lowp=True))
                 for i in drv.sample()]
        return [compare.numbers(*low, *ref) for ref, low in pairs]
    # the reference follows the control's delay refreshes, as it follows
    # the program's in a run
    used = []
    low_state, low_summ, _ = drv.reference(lowp=True, record=used)
    ref_state, ref_summ, gap = drv.reference(follow=used)
    return [dict(compare.numbers(low_state, low_summ, ref_state, ref_summ),
                 delay_gap=gap)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    limits = harness.load_cell(args.workload).traffic["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        for r in control_readings(args.workload, seed, args.device):
            passed, _, _ = compare.judge([r], limits)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": r, "passes_limits": passed}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
