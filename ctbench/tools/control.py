"""Readings of the check: the program over many seeds, and its control.

    python3 ctbench/tools/control.py --workload p5_fdk_batch \
        --seeds 12 --control-seeds 3 --seconds 2

Runs the cell in this one process (every run a whole run: set-up, a
short window at the cell's own load, the check), first on ``--seeds``
seeds as the configuration states, then on ``--control-seeds`` seeds
with the program's own lower-precision path switched on (``precision``
``bf16``: the nearest precision below the configuration's float32).
Prints one JSON line per run with the numbers the check compared; the
limits in the configuration files are set from these readings.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
#: the control's precision: the nearest below the configurations' float32
CONTROL = "bf16"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from ctbench.core import run_cell
    plan = ([(s, None) for s in range(args.seeds)]
            + [(args.seeds + s, {"precision": CONTROL})
               for s in range(args.control_seeds)])
    for k, over in plan:
        seed = args.first_seed + 7919 * k
        t = time.perf_counter()
        res = run_cell(ROOT, args.workload, seed, args.seconds, False,
                       overrides=over)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "precision": (over or {}).get("precision", "config"),
            "rel_rmse": res["check"]["rel_rmse"]["value"],
            "attempted": res["attempted"], "failed": res["failed"],
            "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
