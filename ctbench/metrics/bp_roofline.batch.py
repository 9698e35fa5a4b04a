"""bp_roofline.batch: the back-projection's share of its roofline, in %.

The least time a volume's back-projection can take on the card is the
larger of its operations over the float32 peak and its bytes over the
memory bandwidth, counted from the configuration's shapes alone (the
algorithm's work, whichever kernel runs it):

* operations: 8 a voxel-view update (the row's affine step, two
  interpolations and the weighted accumulate), nx * ny * nz * views
  updates;
* bytes: the float32 scan read once and the float32 volume written once.

The share is that least time, times the volumes completed in the window,
over the device time of every kernel launched inside the program's
``step.dispatch`` ranges (``REPRO_TRACE_NVTX=1``) in the window.
"""

FLOPS_PER_UPDATE = 8
PEAK_FLOPS = 67e12        # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM, HBM3


def least_seconds(cfg: dict) -> float:
    n, v, d = cfg["volume"], cfg["views"], cfg["detector"]
    flops = FLOPS_PER_UPDATE * n ** 3 * v
    nbytes = 4 * (v * d * d + n ** 3)
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def read(run):
    if run.trace is None or not run.records:
        return None
    inside, _ = run.trace.launched_inside("step.dispatch")
    busy = sum(a.dur for a in inside if a.cat == "kernel") / 1e6
    if busy <= 0:
        return None
    return 100.0 * len(run.records) * least_seconds(run.config) / busy
