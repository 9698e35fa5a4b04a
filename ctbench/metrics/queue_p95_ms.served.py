"""queue_p95_ms.served: the 95th percentile over the window's requests
of the length of the program's ``request.queue`` span that carries the
request's trace id: its wait from its submit to its dispatch, as the
program times it. A request with no such span counts as infinitely
late; None where the program records none at all."""

from ctbench.core import percentile


def read(run):
    if run.spans is None or not run.records:
        return None
    waits = {e["args"]["trace_id"]: e["dur"] / 1e6 for e in run.spans
             if e.get("ph") == "X" and e.get("name") == "request.queue"}
    if not waits:
        return None
    return 1e3 * percentile([waits.get(r.get("trace_id"), float("inf"))
                             for r in run.records], 95.0)
