"""Device ms a delivered scan inside the device interval of the span
"lidar_odometry" (runtime/pipeline.py: the step's argument copies, its
replay and the pose's copy to the host), over the window. A span's device
interval runs from the event at its entry to the event at its exit: it
covers the kernels the span enqueued and any launch gaps between them.
None without a span log."""
from vilbench import spans


def read(rec):
    log = getattr(rec, "spans", None)
    t = spans.device_seconds(log, "lidar_odometry") if log else None
    if t is None or not rec.delivered:
        return None
    return 1e3 * t / rec.delivered
