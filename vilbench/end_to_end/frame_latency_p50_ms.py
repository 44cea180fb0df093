"""Median over every frame delivered inside the window of the time from
the push of the frame's first event to the return of its pose (under
sync_depth=2 that return comes with the push of the frame two later)."""
import numpy as np


def read(rec):
    if not rec.latencies_s:
        return None
    return float(np.median(np.asarray(rec.latencies_s) * 1e3))
