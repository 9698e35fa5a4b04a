"""wait_p95_ms.served: the 95th percentile over the window's requests of
the time from a request's due time to the start of the program's
``service.dispatch`` span that carries its trace id: the wait in the
queue and the batch former. A request never dispatched counts as
infinitely late."""

from ctbench.core import percentile


def read(run):
    if run.spans is None or not run.records:
        return None
    start = {}
    for e in run.spans:
        if e.get("ph") == "X" and e.get("name") == "service.dispatch":
            for tid in e.get("args", {}).get("trace_ids", ()):
                start[tid] = e["ts"] / 1e6 - run.window_start
    if not start:
        return None
    waits = [start[r["trace_id"]] - r["due"]
             if r.get("trace_id") in start else float("inf")
             for r in run.records]
    return 1e3 * percentile(waits, 95.0)
