"""ingest_pinned_share.served: the share of the bytes of the program's
``ingest`` spans started in the window that went to the card through
pinned staging (the span's ``path`` is ``"pinned"``). A span without a
``path`` counts as pageable. None where the program records no such span
in the window."""


def read(run):
    if run.spans is None:
        return None
    t0 = run.window_start * 1e6
    t1 = (run.window_start + run.window_s) * 1e6
    spans = [e for e in run.spans
             if e.get("ph") == "X" and e.get("name") == "ingest"
             and t0 <= e["ts"] < t1]
    total = sum(e["args"].get("bytes", 0) for e in spans)
    if total == 0:
        return None
    pinned = sum(e["args"].get("bytes", 0) for e in spans
                 if e["args"].get("path") == "pinned")
    return pinned / total
