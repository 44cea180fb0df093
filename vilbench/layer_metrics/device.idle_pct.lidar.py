"""Share of the traced sub-window's wall time that no device operation's
interval covers (the union of the intervals, torch.profiler)."""


def read(rec):
    tr = rec.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
