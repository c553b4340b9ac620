"""Worker entry point of the multi-process sweep fabric
(``repro.launch.dist_worker``'s counterpart).

Parses the worker arguments, sets the worker's CPU threads from
``OMP_NUM_THREADS`` where it is set, joins the ``torch.distributed``
gloo group (unless ``--no-dist-init``; the counterpart of
``jax.distributed.initialize``, and as there the compute never depends
on it), then imports the fabric and runs this worker's slabs.  The group
is torn down on the way out (no barrier: a worker that finishes early
must not time out waiting on a slow one; worker 0, which holds the
group's store, leaves last, once every worker has been told DONE).

    python -m repro_torch.launch.dist_worker --spec grid_spec.json \\
        --out RUN --process-id 1 --num-processes 4 \\
        --coordinator host0:1234 --handout host0:1235 --device cuda
"""
from __future__ import annotations

import argparse
import datetime
import os
import sys

# how long the process group waits for its peers: a worker that dies
# before the rendezvous must not hold the others past the launcher's
# kill-on-first-failure for long
GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def parse_args(argv):
    ap = argparse.ArgumentParser("repro_torch.launch.dist_worker")
    ap.add_argument("--spec", required=True,
                    help="GridSpec JSON (see repro_torch.launch.dist)")
    ap.add_argument("--out", required=True, help="shared run directory")
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--handout", default=None,
                    help="host:port of the slab coordinator (process 0 "
                         "serves it); omitted = static round-robin slabs")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the gloo group's TCP store")
    ap.add_argument("--no-dist-init", action="store_true",
                    help="skip torch.distributed (pure slab-worker mode)")
    ap.add_argument("--device", default="cuda",
                    help="torch device type of this worker (default cuda)")
    ap.add_argument("--spawned-at", type=float, default=None,
                    help="the launcher's clock at spawn (time.time()), for "
                         "the start-up time in the worker meta")
    ap.add_argument("--server-timeout", type=float, default=120.0)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    a = parse_args(sys.argv[1:] if argv is None else list(argv))
    import torch
    if os.environ.get("OMP_NUM_THREADS"):
        torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    group = not a.no_dist_init
    if group:
        if not a.coordinator:
            raise SystemExit("--coordinator required unless --no-dist-init")
        import torch.distributed as tdist
        tdist.init_process_group(
            "gloo", init_method=f"tcp://{a.coordinator}",
            world_size=a.num_processes, rank=a.process_id,
            timeout=GROUP_TIMEOUT)
    try:
        from repro_torch.launch import dist
        dist.worker_run(a)
    finally:
        if group:
            tdist.destroy_process_group()


if __name__ == "__main__":
    main()
