"""ingest_ms.served: host milliseconds of the program's ``ingest`` spans
started in the window, a request completed: how long the workers'
threads are held by the copies of host scans to the card, waits behind
other work on the stream included. None where the program records no
such span."""


def read(run):
    done = sum(1 for r in run.records if r.get("ok"))
    if run.spans is None or done == 0:
        return None
    t0 = run.window_start * 1e6
    t1 = (run.window_start + run.window_s) * 1e6
    spans = [e for e in run.spans
             if e.get("ph") == "X" and e.get("name") == "ingest"
             and t0 <= e["ts"] < t1]
    if not spans:
        return None
    return sum(e["dur"] for e in spans) / 1e3 / done
