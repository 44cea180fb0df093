"""Host launches a scan in the traced sub-window: kernel launches plus
CUDA graph launches (profiler CPU events), over its scans."""


def read(rec):
    tr = rec.trace
    return None if tr is None or not tr.frames else tr.launches / tr.frames
