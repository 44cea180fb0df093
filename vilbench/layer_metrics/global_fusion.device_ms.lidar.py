"""Device ms a delivered scan inside the device interval of the span
"global_fusion" (models/global_fusion.py add_frame: keyframe program, ICP
verifications, relaxations), over the window. A span's device interval runs
from the event at its entry to the event at its exit: it covers the kernels
the span enqueued and any launch gaps between them. None without a span
log."""
from vilbench import spans


def read(rec):
    log = getattr(rec, "spans", None)
    t = spans.device_seconds(log, "global_fusion") if log else None
    if t is None or not rec.delivered:
        return None
    return 1e3 * t / rec.delivered
