"""h2d_ms.served: device time of host-to-device copies in the window, a
request completed: the ingest of the scans handed over as host arrays."""


def read(run):
    done = sum(1 for r in run.records if r.get("ok"))
    if run.trace is None or not run.trace.has_device() or done == 0:
        return None
    copies = [a for a in run.trace.in_window()
              if a.cat == "gpu_memcpy" and "HtoD" in a.name]
    return sum(a.dur for a in copies) / 1e3 / done
