"""gups: voxel-view updates of every volume completed in the window
(nx * ny * nz * views each), over the window's seconds, in 1e9 a
second: the paper's GUPS."""


def read(run):
    if not run.records or run.window_s <= 0:
        return None
    return len(run.records) * run.updates_per_volume / run.window_s / 1e9
