"""stack_device_ms.batch: device time a volume of the kernels, copies
and memsets launched inside the program's ``filter.stack`` ranges
(``REPRO_TRACE_NVTX=1``): the zero-filled chunk grid and the copy of
each filtered chunk into it. None where the trace holds no such
range."""


def read(run):
    if run.trace is None or not run.records:
        return None
    inside, _ = run.trace.launched_inside("filter.stack")
    if not inside:
        return None
    return sum(a.dur for a in inside) / 1e3 / len(run.records)
