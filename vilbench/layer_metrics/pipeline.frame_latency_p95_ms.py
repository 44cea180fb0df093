"""95th percentile over every frame delivered inside the window of the
time from the push of the frame's first event to the return of its pose.
Its runs fall in two groups ~15% apart (PERF.md), so it stands here,
beside the median end to end."""
import numpy as np


def read(rec):
    if not rec.latencies_s:
        return None
    return float(np.percentile(np.asarray(rec.latencies_s) * 1e3, 95))
