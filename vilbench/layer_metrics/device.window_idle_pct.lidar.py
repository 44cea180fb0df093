"""Share of the measured window's wall time in which the device is not
known busy (the program's span log with device timing, vilbench/spans.py):
in which no span's timing event is pending, recorded on the host and not
yet reached by the device. A span's device interval (from the event at its
entry to the event at its exit) covers the kernels the span enqueued and
any launch gaps between them, and a span that enqueues nothing while the
device waits would count as busy by it; a pending event means the device is
still working through what came before it. An upper bound of the idle
share: work that ends before the next event is recorded is not seen. None
without a span log."""
from vilbench import spans


def read(rec):
    log = getattr(rec, "spans", None)
    if not log:
        return None
    return spans.idle_pct(log, *rec.span_window)
