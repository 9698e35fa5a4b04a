"""Run one benchmark cell once and print its result line.

    python3 ctbench/run.py --workload p5_fdk_batch --seed 7 --seconds 30 \
        --trace 0

Run it from the checkout's root. It loads, warms up, measures for
``--seconds``, checks the volumes against the plain reference and prints
one JSON object as the last line of standard output, with the numbers
it compared beside their limits as the last lines of standard error.
It exits non-zero, printing no result, without the cards the cell asks
for, or when JAX or the JAX package was loaded into the process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from ctbench.core import NoDevice, forbidden_modules, run_cell
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START)
    except NoDevice as exc:
        print(f"ctbench: no run: {exc}", file=sys.stderr)
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"ctbench: the process loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
