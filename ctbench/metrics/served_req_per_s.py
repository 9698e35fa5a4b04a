"""served_req_per_s: requests served a second: every request of the
window over the window's seconds, from its start to the resolution of
the last future (the arrivals' span and the drain of the queue they
left). A failed request is not counted as served."""


def read(run):
    done = sum(1 for r in run.records if r.get("ok"))
    if done == 0 or run.window_s <= 0:
        return None
    return done / run.window_s
