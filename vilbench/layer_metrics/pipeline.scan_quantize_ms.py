"""Host ms a delivered scan in the scan's fixed-point quantization and bit
packing (GLOBAL_TIMERS "scan_quantize": runtime/pipeline.py push_scan),
over the window."""


def read(rec):
    t = rec.timers.get("scan_quantize")
    if not t or not rec.delivered:
        return None
    return 1e3 * t["total_s"] / rec.delivered
