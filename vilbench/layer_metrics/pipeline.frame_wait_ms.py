"""Host ms a delivered frame that the pipeline waits for a deferred
frame's results (GLOBAL_TIMERS "frame_wait", runtime/pipeline.py
_complete_frame), over the window."""


def read(rec):
    t = rec.timers.get("frame_wait")
    if not t or not rec.delivered:
        return None
    return 1e3 * t["total_s"] / rec.delivered
