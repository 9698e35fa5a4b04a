"""Find the served cell's knee: the open loop at several fixed rates.

    python3 ctbench/tools/sweep.py --workload p5_served_open \
        --rates 4 6 8 10 12 --seconds 20

One process, one warmed service: for each rate in turn the open loop of
the cell's traffic mix (its arrival pattern, at that rate) runs for
``--seconds`` and drains.
Prints one JSON line per rate: arrivals, the rate of completions while
requests arrived, the requests outstanding at a quarter, half and the
end of the arrivals (a backlog that grows says the rate is past the
knee), and the latency's median and 95th percentile. The knee is the
highest rate whose completions keep up and whose backlog does not grow.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def outstanding(records, t):
    return sum(1 for r in records if r["due"] <= t
               and (r["done"] is None or r["done"] > t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="p5_served_open")
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=2_900_000_001)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from ctbench.check import Sampler
    from ctbench.core import Run, load_cell, percentile, require_cards, sync
    cell = load_cell(ROOT, args.workload)
    require_cards(cell.entry["chips"])
    run = Run(config=cell.config, traffic=cell.traffic, seed=args.seed,
              seconds=args.seconds, device="cuda", traced=False)
    sampler = Sampler(cell.config, cell.traffic, args.seed, "cuda")
    gen = cell.generator.Generator(run, sampler)
    gen.setup()
    for rate in args.rates:
        gen.rate = rate
        gen.due, gen.scan_of = gen.schedule(rate)
        run.records, run.attempted, run.failed = [], 0, 0
        sync("cuda")
        run.window_start = time.perf_counter()
        gen.window()
        gen.finish()
        rec = run.records
        t_end = args.seconds
        done_in = sum(1 for r in rec if r["ok"] and r["done"] <= t_end)
        lat = [r["latency"] for r in rec]
        print(json.dumps({
            "rate_per_s": rate, "arrivals": len(rec), "failed": run.failed,
            "completed_per_s_while_arriving": done_in / t_end,
            "outstanding": [outstanding(rec, f * t_end)
                            for f in (0.25, 0.5, 0.75, 1.0)],
            "p50_ms": 1e3 * percentile(lat, 50),
            "p95_ms": 1e3 * percentile(lat, 95),
            "drain_s": run.window_s - t_end,
            "occupancy": (run.counters["completed"]
                          / max(1, run.counters["dispatches"]))}),
            flush=True)
        gen.base = gen._counts()
        run.notes.clear()
        time.sleep(2.0)
    gen.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
