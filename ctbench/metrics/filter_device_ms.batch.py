"""filter_device_ms.batch: device time a volume of the kernels, copies
and memsets launched inside the program's ``filter.chunk`` ranges
(``REPRO_TRACE_NVTX=1``): the pre-weighting, the ramp filter and the
transpose. None where the trace holds no such range."""


def read(run):
    if run.trace is None or not run.records:
        return None
    inside, _ = run.trace.launched_inside("filter.chunk")
    if not inside:
        return None
    return sum(a.dur for a in inside) / 1e3 / len(run.records)
