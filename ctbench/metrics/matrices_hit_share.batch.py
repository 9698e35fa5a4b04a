"""matrices_hit_share.batch: the share of the program's
``geometry.matrices`` spans started in the window whose ``cached`` arg
is true, the per-view matrices taken from the program's cache rather
than built on the host. A span without ``cached`` counts as a build.
None where the program records no such span in the window."""


def read(run):
    if run.spans is None:
        return None
    t0 = run.window_start * 1e6
    t1 = (run.window_start + run.window_s) * 1e6
    spans = [e for e in run.spans
             if e.get("ph") == "X" and e.get("name") == "geometry.matrices"
             and t0 <= e["ts"] < t1]
    if not spans:
        return None
    hits = sum(1 for e in spans if e.get("args", {}).get("cached") is True)
    return hits / len(spans)
