"""The port's native runtime (vil_fusion_tpu_torch/runtime/native.py): its
build into build/native/, the ring bus's semantics (the cases of
tests/test_native.py, on the library and on its plain deque version), and
the sensor loaders bit for bit against the JAX package's native functions
and against the port's plain versions."""
import threading
from pathlib import Path

import numpy as np
import pytest

from vil_fusion_tpu.runtime import native as jnative
from vil_fusion_tpu_torch.runtime import native

REPO = Path(__file__).resolve().parents[1]
TOPICS = [pytest.param(native.Topic, id="native"), pytest.param(native.PlainTopic, id="plain")]


def test_native_builds_into_build_dir():
    lib = native.build()
    path = native.library_path()
    assert path.parent == REPO / "build" / "native" and path.is_file()
    assert lib is native.build()  # loaded once
    # the sources are the reference's, byte for byte
    for name in ("Makefile", "src/ringbus.cpp", "src/sensor_io.cpp"):
        assert ((REPO / "vil_fusion_tpu_torch" / "native" / name).read_bytes()
                == (REPO / "vil_fusion_tpu" / "native" / name).read_bytes())


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No silent fallback: a compiler failure raises with its output."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native.build()


@pytest.mark.parametrize("topic_cls", TOPICS)
def test_topic_pub_poll_roundtrip(topic_cls):
    t = topic_cls("test", slot_bytes=1024, capacity=8)
    payload = np.arange(64, dtype=np.float32)
    assert t.publish(1.5, payload)
    assert t.pending() == 1
    ts, data = t.poll(dtype=np.float32)
    assert ts == 1.5
    np.testing.assert_array_equal(data, payload)
    assert t.poll() is None


@pytest.mark.parametrize("topic_cls", TOPICS)
def test_topic_drop_oldest_when_full(topic_cls):
    t = topic_cls("drops", slot_bytes=8, capacity=4)
    for i in range(10):
        t.publish(float(i), np.asarray([i], np.int64))
    assert t.pending() == 4 and t.dropped() == 6
    got = []
    while (msg := t.poll(dtype=np.int64)) is not None:
        got.append((msg[0], int(msg[1][0])))
    assert got == [(6.0, 6), (7.0, 7), (8.0, 8), (9.0, 9)]  # the newest four


@pytest.mark.parametrize("topic_cls", TOPICS)
def test_topic_oversized_payload_rejected(topic_cls):
    t = topic_cls("small", slot_bytes=16, capacity=4)
    assert not t.publish(0.0, np.zeros(100, np.float64))
    assert t.pending() == 0 and t.dropped() == 0


@pytest.mark.parametrize("topic_cls", TOPICS)
def test_topic_threaded_producer_consumer(topic_cls):
    t = topic_cls("spsc", slot_bytes=64, capacity=64)
    n = 2000
    got = []

    def producer():
        for i in range(n):
            while not t.publish(float(i), np.asarray([i], np.int64)):
                pass

    def consumer():
        while len(got) < n - t.dropped():
            r = t.poll(dtype=np.int64)
            if r is not None:
                got.append(int(r[1][0]))
            if t.pending() == 0 and not prod.is_alive():
                break

    prod = threading.Thread(target=producer)
    cons = threading.Thread(target=consumer)
    prod.start()
    cons.start()
    prod.join(timeout=30)
    cons.join(timeout=30)
    assert not prod.is_alive() and not cons.is_alive()
    # values arrive in order (drops allowed under backpressure)
    assert len(got) > 0
    assert all(b > a for a, b in zip(got, got[1:]))


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,max_pts", [(1000, 200_000), (1000, 640), (0, 10)])
def test_load_kitti_bin(tmp_path, n, max_pts):
    pts = np.random.default_rng(0).normal(size=(n, 4)).astype(np.float32)
    path = str(tmp_path / "000000.bin")
    pts.tofile(path)
    xyz, inten = native.load_kitti_bin(path, max_pts)
    for ref in (jnative.load_kitti_bin(path, max_pts), native.load_kitti_bin_plain(path, max_pts)):
        _same_bits(xyz, ref[0])
        _same_bits(inten, ref[1])
    _same_bits(xyz, pts[:max_pts, :3])
    with pytest.raises(FileNotFoundError):
        native.load_kitti_bin(str(tmp_path / "missing.bin"))


@pytest.mark.parametrize("skip,max_rows", [(1, 1_000_000), (1, 2), (0, 10)])
def test_load_csv_floats(tmp_path, skip, max_rows):
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(5, 7)) * 10.0 ** rng.integers(-9, 9, (5, 7))
    rows[:, 0] = 1_400_000_000_000_000_000 + np.arange(5) * 5_000_000  # EuRoC stamps
    path = tmp_path / "data.csv"
    path.write_text(("#timestamp,wx,wy,wz,ax,ay,az\n" if skip else "")
                    + "".join(",".join(repr(float(v)) for v in r) + "\n" for r in rows))
    out = native.load_csv_floats(str(path), 7, max_rows=max_rows, skip_lines=skip)
    _same_bits(out, jnative.load_csv_floats(str(path), 7, max_rows=max_rows, skip_lines=skip))
    _same_bits(out, native.load_csv_floats_plain(str(path), 7, max_rows=max_rows,
                                                 skip_lines=skip))
    _same_bits(out, rows[:max_rows])


@pytest.mark.parametrize("h,w,maxval,comment", [(3, 4, 255, False), (48, 64, 255, True),
                                                (7, 5, 100, False)])
def test_load_pgm(tmp_path, h, w, maxval, comment):
    img = np.random.default_rng(2).integers(0, maxval + 1, (h, w)).astype(np.uint8)
    path = tmp_path / "img.pgm"
    with open(path, "wb") as f:
        f.write(b"P5\n" + (b"# a comment\n" if comment else b"")
                + f"{w} {h}\n{maxval}\n".encode() + img.tobytes())
    out = native.load_pgm(str(path))
    assert out.shape == (h, w) and out.dtype == np.float32
    _same_bits(out, jnative.load_pgm(str(path)))
    _same_bits(out, native.load_pgm_plain(str(path)))
    np.testing.assert_allclose(out, img / maxval, atol=1e-6)
