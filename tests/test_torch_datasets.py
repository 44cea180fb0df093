"""The port's dataset readers, PNG codec and replay
(vil_fusion_tpu_torch/runtime/{datasets,imageio}.py) against the JAX
package's: the same events element for element from the same files, PNG
decoding equal to PIL's, the ADVIO mask stream and a KITTI odometry
sequence through `replay`, and the run_dataset entry point on the CPU."""
import io
import json
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import torch_dataset_fixtures as fx
from vil_fusion_tpu.runtime import datasets as jdatasets
from vil_fusion_tpu_torch.runtime import datasets, imageio
from vil_fusion_tpu_torch.runtime import sim as tsim

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("reader,fixture", [
    ("KittiOdometry", fx.kitti_odom), ("KittiRaw", fx.kitti_raw),
    ("EuRoC", fx.euroc), ("ADVIO", fx.advio)])
def test_reader_events_equal_reference(tmp_path, reader, fixture):
    root = fixture(tmp_path)
    args = (root, "07") if reader == "KittiOdometry" else (root,)
    port, ref = getattr(datasets, reader)(*args), getattr(jdatasets, reader)(*args)
    evs = list(port.events())
    fx.events_equal(evs, list(ref.events()))
    assert [e[1] for e in evs] == sorted(e[1] for e in evs)
    if reader != "KittiRaw":
        for a, b in zip(port.ground_truth(), ref.ground_truth()):
            np.testing.assert_array_equal(a, b)
    if reader == "KittiRaw":  # 12 oxts rows, 3 scans, 3 RGB frames across 13:02 -> 13:03
        assert [e[0] for e in evs].count("imu") == 12
        assert [e[0] for e in evs].count("image") == 3
        assert evs[-1][1] > 13 * 3600 + 3 * 60


def test_kitti_odometry_frame_and_jpg(tmp_path):
    root = fx.kitti_odom(tmp_path)
    t, xyz, img = datasets.KittiOdometry(root, "07").frame(0)
    tj, xyzj, imgj = jdatasets.KittiOdometry(root, "07").frame(0)
    assert t == tj and img.dtype == np.uint8 and img.shape == (60, 80)
    np.testing.assert_array_equal(xyz, xyzj)
    np.testing.assert_array_equal(img, imgj)
    # deviation: a .jpg frame raises with its name (the reference decodes it with PIL)
    img_dir = Path(root) / "sequences" / "07" / "image_0"
    os.remove(img_dir / "000001.pgm")
    Image.fromarray(np.zeros((60, 80), np.uint8)).save(img_dir / "000001.jpg")
    with pytest.raises(NotImplementedError, match="000001.jpg"):
        datasets.KittiOdometry(root, "07").frame(1)


def _pil_png(arr):
    b = io.BytesIO()
    Image.fromarray(arr).save(b, format="PNG")
    return b.getvalue()


@pytest.mark.parametrize("mode,shape,dtype", [
    ("L", (37, 53), np.uint8), ("LA", (37, 53, 2), np.uint8), ("RGB", (37, 53, 3), np.uint8),
    ("RGBA", (37, 53, 4), np.uint8), ("I;16", (37, 53), np.uint16)])
def test_png_decode_equals_pil(tmp_path, mode, shape, dtype):
    """Random images, smooth enough that PIL's adaptive encoder picks varied
    row filters: PIL's file and the port's with each of the five filters
    decode to the same samples, and read_grey equals PIL's convert("L")."""
    rng = np.random.default_rng(5)
    hi = 65536 if dtype == np.uint16 else 256
    ramp = np.linspace(0, hi // 2, shape[1]).reshape((1, -1) + (1,) * (len(shape) - 2))
    arr = ((rng.integers(0, hi // 2, shape) + ramp) % hi).astype(dtype)
    files = {"pil": _pil_png(arr)}
    files.update({f"filter{f}": imageio.encode_png(arr, f) for f in range(5)})
    for name, data in files.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        got = imageio.read_png(str(path))
        assert got.dtype == dtype and got.shape == shape, name
        np.testing.assert_array_equal(got, arr, err_msg=name)
        pil = Image.open(path)
        np.testing.assert_array_equal(np.asarray(pil), arr, err_msg=name)
        np.testing.assert_array_equal(imageio.read_grey(str(path)), np.asarray(pil.convert("L")),
                                      err_msg=name)


def test_png_unsupported_raise(tmp_path):
    data = bytearray(imageio.encode_png(np.zeros((4, 4), np.uint8)))
    # set IHDR's interlace byte (offset 8 + 8 + 12) and refresh its CRC
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
    path = tmp_path / "interlaced.png"
    path.write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="interlaced.png"):
        imageio.read_png(str(path))
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(tmp_path / "palette.png")
    with pytest.raises(NotImplementedError, match="palette.png"):
        imageio.read_png(str(tmp_path / "palette.png"))


def test_advio_mask_stream_through_replay(tmp_path):
    """The ADVIO stream (separate-clock IMU, frames, a mask for frame 1)
    through the port's replay into mode "mask": the mask reaches push_image
    for frame 1 only (tests/test_datasets.py's case)."""
    from vil_fusion_tpu_torch.runtime.config import RigConfig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline

    ds = datasets.ADVIO(fx.advio(tmp_path))
    rig = RigConfig(
        name="advio-test",
        camera=dict(model_type="PINHOLE",
                    projection_parameters=dict(fx=40.0, fy=40.0, cx=32.0, cy=24.0),
                    distortion_parameters=dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0)),
        image_height=48, image_width=64, max_cnt=20, min_dist=8,
        q_ic=np.array([1.0, 0, 0, 0]), t_ic=np.zeros(3),
        use_lidar=False)
    pipe = VILFusionPipeline(rig, mode="mask", device="cpu")
    seen_masks = []
    orig_push = pipe.push_image

    def spy_push(t, img, mask=None):
        seen_masks.append(mask is not None)
        return orig_push(t, img, mask=mask)

    pipe.push_image = spy_push
    stats = {}
    datasets.replay(pipe, ds.events(), stats=stats)
    assert len(pipe.outputs.ts) == 3
    assert seen_masks == [False, True, False]
    assert stats["events"] == 23 and stats["dropped"] == 0


def test_kitti_replay_lidar_matches_reference(tmp_path):
    """A simulator KITTI odometry sequence (6 scans of 16 x 900, written as
    .bin files) through both packages' replay into mode "lidar" with the
    exact kNN: lidar poses within tests/test_torch_pipeline.py's tolerance
    (0.02 m, 0.01 rad) of the JAX pipeline's, and within 0.1 m of the truth."""
    from test_torch_pipeline import GF, ODOM, RIG_KW
    from vil_fusion_tpu.models import global_fusion as jgf
    from vil_fusion_tpu.runtime.config import RigConfig as JRig
    from vil_fusion_tpu.runtime.pipeline import VILFusionPipeline as JPipeline
    from vil_fusion_tpu_torch.models import global_fusion as tgf
    from vil_fusion_tpu_torch.runtime.config import RigConfig as TRig
    from vil_fusion_tpu_torch.runtime.pipeline import VILFusionPipeline as TPipeline

    gt = fx.write_sim_kitti(tmp_path, tsim, datasets, 6)
    odom = dict(ODOM, approx_knn=False)
    jp = JPipeline(JRig(**RIG_KW), mode="lidar", odom_overrides=odom,
                   gf_cfg=jgf.GlobalFusionConfig(**GF))
    tp = TPipeline(TRig(**RIG_KW), mode="lidar", odom_overrides=odom,
                   gf_cfg=tgf.GlobalFusionConfig(**GF), device="cpu")
    jdatasets.replay(jp, jdatasets.KittiOdometry(str(tmp_path), "00").events())
    stats = {}
    datasets.replay(tp, datasets.KittiOdometry(str(tmp_path), "00").events(), stats=stats)
    assert stats["events"] == 6 and stats["dropped"] == 0
    assert len(tp.outputs.ts) == len(jp.outputs.ts) == 6
    pt, pj = np.stack(tp.outputs.lidar_p), np.stack(jp.outputs.lidar_p)
    assert np.abs(pt - pj).max() < 0.02, np.abs(pt - pj).max(1)
    qt, qj = np.stack(tp.outputs.lidar_q), np.stack(jp.outputs.lidar_q)
    assert np.all(2 * np.arccos(np.clip(np.abs(np.sum(qt * qj, 1)), 0, 1)) < 0.01)
    assert np.linalg.norm(pt - gt, axis=1).max() < 0.1


def test_run_dataset_cli_lidar_cpu(tmp_path):
    """python -m vil_fusion_tpu_torch.tools.run_dataset on the KITTI fixture,
    mode lidar on the CPU: exit 0, a report of 4 frames, the TUM files."""
    root = fx.kitti_odom(tmp_path)
    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "-m", "vil_fusion_tpu_torch.tools.run_dataset", "--dataset", "kitti",
         "--data", root, "--seq", "07", "--config", "configs/kitti.yaml", "--mode", "lidar",
         "--out", str(out), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr[-2000:]
    rep = json.loads((out / "report.json").read_text())
    assert rep["frames"] == 4 and rep["device"] == "cpu" and "ate_rmse_vio" in rep
    assert rep["replay"]["events"] == 8 and rep["replay"]["dropped"] == 0
    assert (out / "lidar_odometry.txt").is_file()
    assert len((out / "lidar_odometry.txt").read_text().splitlines()) == 4
