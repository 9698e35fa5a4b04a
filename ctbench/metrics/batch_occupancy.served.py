"""batch_occupancy.served: requests the service completed in the window
over its dispatches then (``ServiceStats`` counts): how full its formed
batches were."""


def read(run):
    d = run.counters.get("dispatches", 0)
    if d <= 0:
        return None
    return run.counters["completed"] / d
