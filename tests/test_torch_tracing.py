"""The port's stage timers (utils/tracing.py): the bounded sample
reservoir overwrites its oldest sample first."""
from vil_fusion_tpu_torch.utils import tracing


def test_reservoir_overwrites_oldest_first(monkeypatch):
    """With room for 4 samples, samples 1-4 fill the slots in order and
    sample n > 4 replaces sample n - 4: slot (n - 1) % 4. (The reference
    writes slot n % 4, so its fifth sample replaced the second and the first
    stayed a whole extra cycle.) n, total and max count every sample."""
    monkeypatch.setattr(tracing, "MAX_SAMPLES", 4)
    timers = tracing.StageTimers()
    values = iter([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0])
    monkeypatch.setattr(tracing.time, "perf_counter", lambda: 0.0)
    expected = {5: [5.0, 2.0, 3.0, 4.0], 6: [5.0, 6.0, 3.0, 4.0], 8: [5.0, 6.0, 7.0, 8.0],
                9: [9.0, 6.0, 7.0, 8.0]}
    for n in range(1, 10):
        v = next(values)
        monkeypatch.setattr(tracing.time, "perf_counter", iter([0.0, v]).__next__)
        with timers.timed("stage"):
            pass
        s = timers.stats["stage"]
        if n <= 4:
            assert s["samples"] == [1.0, 2.0, 3.0, 4.0][:n]
        elif n in expected:
            assert s["samples"] == expected[n], (n, s["samples"])
    assert s["n"] == 9 and s["total"] == 45.0 and s["max"] == 9.0
    summ = timers.summary()["stage"]
    assert summ["n"] == 9 and summ["p50_ms"] == 8000.0
