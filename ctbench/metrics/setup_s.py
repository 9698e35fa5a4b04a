"""setup_s: seconds from process start to the window's start (imports,
the CUDA context, loading or building the kernels, making the scans,
the warm-up)."""


def read(run):
    return run.setup_s
