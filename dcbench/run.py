"""Run one cell of the benchmark and print its result as one JSON line.

    python3 dcbench/run.py --workload sim100-burst --seed 7 --seconds 30 \
        --trace 0

From the root of a checkout.  Exits non-zero, printing no result, where
there is no CUDA device (or fewer than the cell asks for), where the
port cannot be imported, or where the run loaded JAX or the JAX package.
The numbers compared with the reference stand, each beside its limit,
as the last lines of standard error and under ``checks``, the result's
last key.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths (the
# port's own CUDA kernels build into src/repro_torch/kernels/build/)
CACHE = ROOT / ".dcbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        from dcbench import harness
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start=T_START)
    except ImportError as e:
        print(f"dcbench: cannot import what the run needs: {e}",
              file=sys.stderr)
        return 2
    except harness.RunError as e:
        print(f"dcbench: {e}", file=sys.stderr)
        return 2
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
