"""Host ms a delivered frame in global fusion (GLOBAL_TIMERS
"global_fusion": models/global_fusion.py add_frame), over the window."""


def read(rec):
    t = rec.timers.get("global_fusion")
    if not t or not rec.delivered:
        return None
    return 1e3 * t["total_s"] / rec.delivered
