"""prep_device_ms.batch: device time a volume of the kernels, copies and
memsets launched outside the program's ``step.dispatch`` ranges: the
pre-weighting, the ramp filter, the transposes, the matrices' copy and
the zeroed buffers."""


def read(run):
    if run.trace is None or not run.trace.has_device() or not run.records:
        return None
    _, rest = run.trace.launched_inside("step.dispatch")
    return sum(a.dur for a in rest) / 1e3 / len(run.records)
