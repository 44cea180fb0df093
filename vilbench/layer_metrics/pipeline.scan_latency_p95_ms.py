"""95th percentile of the push_scan calls' durations inside the window
(the scan's pose comes back from the call)."""
import numpy as np


def read(rec):
    if not rec.call_s:
        return None
    return float(np.percentile(np.asarray(rec.call_s) * 1e3, 95))
