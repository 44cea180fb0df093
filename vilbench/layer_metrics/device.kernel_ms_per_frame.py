"""Device ms a frame in the traced sub-window: the summed durations of its
device operations (kernels, copies, sets) over its frames."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.kernels:
        return None
    return 1e3 * sum(s for _, s in tr.kernels.values()) / tr.frames
