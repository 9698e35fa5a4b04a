"""matrices_ms.batch: host milliseconds a volume of the program's
``geometry.matrices`` spans started in the window: the per-view
projection matrices built on the host and copied to the card, on every
call. None where the program records no such span."""


def read(run):
    if run.spans is None or not run.records:
        return None
    t0 = run.window_start * 1e6
    t1 = (run.window_start + run.window_s) * 1e6
    spans = [e for e in run.spans
             if e.get("ph") == "X" and e.get("name") == "geometry.matrices"
             and t0 <= e["ts"] < t1]
    if not spans:
        return None
    return sum(e["dur"] for e in spans) / 1e3 / len(run.records)
