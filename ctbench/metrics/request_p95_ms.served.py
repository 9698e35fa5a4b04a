"""request_p95_ms.served: the 95th percentile over every request of the window
of the time from its due time to the resolution of its future; a failed
or unfinished request counts as infinitely late."""

from ctbench.core import percentile


def read(run):
    lat = [r["latency"] for r in run.records if "latency" in r]
    if not lat:
        return None
    return 1e3 * percentile(lat, 95.0)
