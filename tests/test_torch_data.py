"""The port's data layer against the JAX package's: the 12 on-disk loaders,
the dataset configs, the prefetcher, the decoders. No JAX compile here: the
JAX loaders are numpy."""
import glob
import json
import os

import numpy as np
import pytest
import torch

from tests.test_datasets import _camera_params, _write_jpg, _write_png16

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

H, W, FRAMES = 48, 64, 5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_png8(path, arr):
    import cv2

    cv2.imwrite(str(path), arr[..., ::-1].astype(np.uint8))  # RGB -> BGR


def _frames(rng):
    for i in range(FRAMES):
        color = rng.uniform(0, 255, (H, W, 3))
        depth = rng.uniform(500, 30000, (H, W))
        depth[rng.uniform(size=(H, W)) < 0.05] = 0  # holes
        c2w = np.eye(4)
        c2w[:3, :3] = _rot(0.05 * i)
        c2w[:3, 3] = [0.1 * i, -0.05 * i, 0.02 * i * i]
        yield i, color, depth, c2w


def _rot(a):
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]])


def _quat(c2w):
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(c2w[:3, :3]).as_quat()  # x y z w


def _cfg(name, scale, **extra):
    return {"dataset_name": name,
            "camera_params": {**_camera_params(W, H, scale), **extra}}


def _replica(root, rng):
    seq = root / "room0"
    (seq / "results").mkdir(parents=True)
    lines = []
    for i, color, depth, c2w in _frames(rng):
        _write_jpg(seq / "results" / f"frame{i:06d}.jpg", color)
        _write_png16(seq / "results" / f"depth{i:06d}.png", depth)
        lines.append(" ".join(str(v) for v in c2w.ravel()))
    (seq / "traj.txt").write_text("\n".join(lines) + "\n")
    return _cfg("replica", 6553.5), "room0", {}


def _replica_v2(root, rng, use_train_split):
    for split in ("00", "01"):
        d = root / "room0" / "imap" / split
        (d / "rgb").mkdir(parents=True)
        (d / "depth").mkdir()
        lines = []
        for i, color, depth, c2w in _frames(rng):
            _write_png8(d / "rgb" / f"rgb_{i}.png", color)
            _write_png16(d / "depth" / f"depth_{i}.png", depth)
            lines.append(" ".join(str(v) for v in c2w.ravel()))
        (d / "traj_w_c.txt").write_text("\n".join(lines) + "\n")
    return (_cfg("replicav2", 1000.0), "room0",
            {"use_train_split": use_train_split})


def _tum_lists(seq, rng, pose_name, header_rows=1):
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    rgb, dep, gt = ["# color images"], ["# depth maps"], ["# ts tx ty tz qx qy qz qw"]
    for i, color, depth, c2w in _frames(rng):
        t = 1305031102.0 + i * 0.05
        td = t + 0.01  # depth stamped 10 ms later, within the 0.08 s window
        _write_png8(seq / "rgb" / f"{t:.6f}.png", color)
        _write_png16(seq / "depth" / f"{td:.6f}.png", depth)
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{td:.6f} depth/{td:.6f}.png")
        q = _quat(c2w)
        gt.append(f"{t - 0.003:.6f} " + " ".join(f"{v:.7f}" for v in c2w[:3, 3])
                  + " " + " ".join(f"{v:.7f}" for v in q))
    # one more color frame 20 ms after the last: within 1/32 s, so the
    # 32 Hz subsampling drops it
    t += 0.02
    _write_png8(seq / "rgb" / f"{t:.6f}.png", color)
    rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
    (seq / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (seq / "depth.txt").write_text("\n".join(dep) + "\n")
    (seq / pose_name).write_text("\n".join(gt[:1] * header_rows + gt[1:]) + "\n")


def _tum(root, rng):
    _tum_lists(root / "fr1", rng, "groundtruth.txt")
    return _cfg("tum", 5000.0, crop_edge=4), "fr1", {}


def _habitat(root, rng):
    _tum_lists(root / "hab", rng, "pose.txt")
    return _cfg("habitat", 1000.0), "hab", {}


def _folders(root, rng, seq, color_dir, color_ext, depth_dir="depth",
             pose=None, color_writer=_write_jpg):
    s = root / seq
    (s / color_dir).mkdir(parents=True)
    (s / depth_dir).mkdir(exist_ok=True)
    if pose:
        (s / pose).mkdir(exist_ok=True)
    poses = []
    for i, color, depth, c2w in _frames(rng):
        color_writer(s / color_dir / f"{i}.{color_ext}", color)
        _write_png16(s / depth_dir / f"{i}.png", depth)
        poses.append(c2w)
    return s, poses


def _scannet(root, rng):
    s, poses = _folders(root, rng, "scene0000_00", "color", "jpg", pose="pose")
    for i, p in enumerate(poses):
        np.savetxt(s / "pose" / f"{i}.txt", p)
    return _cfg("scannet", 1000.0), "scene0000_00", {}


def _ai2thor(root, rng):
    s, poses = _folders(root, rng, "floor1", "color", "png", pose="pose",
                        color_writer=_write_png8)
    for i, p in enumerate(poses):
        np.savetxt(s / "pose" / f"{i}.txt", p)
    return _cfg("ai2thor", 1000.0), "floor1", {}


def _icl(root, rng):
    s, poses = _folders(root, rng, "living0", "rgb", "png",
                        color_writer=_write_png8)
    rows = []
    for p in poses:
        rows += [" ".join(str(v) for v in p[r]) for r in range(3)]
        rows.append("")
    (s / "living0.gt.sim").write_text("\n".join(rows) + "\n")
    return _cfg("icl", 5000.0), "living0", {}


def _azure(root, rng, odom):
    s, poses = _folders(root, rng, "cap0", "color", "jpg")
    if odom == "log":
        lines = []
        for i, p in enumerate(poses):
            lines.append(f"{i} {i} {i + 1}")
            lines += [" ".join(str(v) for v in p[r]) for r in range(4)]
        (s / "odom.log").write_text("\n".join(lines) + "\n")
        return _cfg("azure", 1000.0), "cap0", {"odomfile": "odom.log"}
    if odom == "flat":
        (s / "odom.txt").write_text(
            "\n".join(" ".join(str(v) for v in p.ravel()) for p in poses) + "\n")
        return _cfg("azurekinect", 1000.0), "cap0", {"odomfile": "odom.txt"}
    return _cfg("azure", 1000.0), "cap0", {}


def _record3d(root, rng, name, color_ext, writer):
    s, poses = _folders(root, rng, "scan0", "rgb", color_ext, pose="poses",
                        color_writer=writer)
    for i, p in enumerate(poses):
        np.save(s / "poses" / f"{i}.npy", p)
    return _cfg(name, 1000.0), "scan0", {}


def _scannetpp(root, rng, use_train_split):
    d = root / "scene" / "dslr"
    (d / "undistorted_images").mkdir(parents=True)
    (d / "undistorted_depths").mkdir()
    (d / "nerfstudio").mkdir()
    frames = []
    for i, color, depth, c2w in _frames(rng):
        name = f"DSC{i:05d}.JPG"
        _write_jpg(d / "undistorted_images" / name, color)
        _write_png16(d / "undistorted_depths" / name.replace(".JPG", ".png"),
                     depth)
        frames.append({"file_path": name, "transform_matrix": c2w.tolist(),
                       "is_bad": i == 2})
    meta = {"h": H, "w": W, "fl_x": 100.0, "fl_y": 101.0, "cx": 31.5,
            "cy": 23.5, "frames": frames[:4], "test_frames": frames[4:]}
    (d / "nerfstudio" / "transforms_undistorted.json").write_text(json.dumps(meta))
    (d / "train_test_lists.json").write_text(json.dumps(
        {"train": [f["file_path"] for f in frames[:4]],
         "test": [f["file_path"] for f in frames[4:]]}))
    kw = {"use_train_split": use_train_split}
    if use_train_split:
        kw["ignore_bad"] = True
    return {"dataset_name": "scannetpp"}, "scene", kw


def _nerfcapture(root, rng):
    s = root / "cap"
    (s / "rgb").mkdir(parents=True)
    (s / "depth").mkdir()
    frames = []
    for i, color, depth, c2w in _frames(rng):
        _write_png8(s / "rgb" / f"{i}.png", color)
        _write_png16(s / "depth" / f"{i}.png", depth)
        frames.append({"file_path": f"rgb/{i}.png",
                       "transform_matrix": c2w.tolist()})
    meta = {"h": H, "w": W, "fl_x": 100.0, "fl_y": 101.0, "cx": 31.5,
            "cy": 23.5, "frames": frames[::-1]}
    (s / "transforms.json").write_text(json.dumps(meta))
    return {"dataset_name": "nerfcapture"}, "cap", {}


FORMATS = {
    "replica": _replica,
    "replicav2_train": lambda r, g: _replica_v2(r, g, True),
    "replicav2_test": lambda r, g: _replica_v2(r, g, False),
    "tum": _tum,
    "scannet": _scannet,
    "ai2thor": _ai2thor,
    "icl": _icl,
    "azure_none": lambda r, g: _azure(r, g, None),
    "azure_log": lambda r, g: _azure(r, g, "log"),
    "azure_flat": lambda r, g: _azure(r, g, "flat"),
    "record3d": lambda r, g: _record3d(r, g, "record3d", "png", _write_png8),
    "realsense": lambda r, g: _record3d(r, g, "realsense", "jpg", _write_jpg),
    "scannetpp_train": lambda r, g: _scannetpp(r, g, True),
    "scannetpp_test": lambda r, g: _scannetpp(r, g, False),
    "nerfcapture": _nerfcapture,
    "habitat": _habitat,
}
# native size; resized to a non-integer scale with start, end and stride
SIZES = {"native": dict(desired_height=H, desired_width=W),
         "resized": dict(desired_height=30, desired_width=40, start=1, end=5,
                         stride=2)}


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    out = {}
    for i, (name, writer) in enumerate(FORMATS.items()):
        root = tmp_path_factory.mktemp(name)
        out[name] = (root,) + writer(root, np.random.default_rng(i))
    return out


def _load_both(fixtures, name, size):
    from splatam_tpu.data import get_dataset as jget

    from splatam_torch.data import get_dataset

    root, cfg, seq, kw = fixtures[name]
    kw = {**kw, **SIZES[size]}
    return (get_dataset(json.loads(json.dumps(cfg)), str(root), seq, **kw),
            jget(json.loads(json.dumps(cfg)), str(root), seq, **kw))


def _assert_same(ds, jds):
    assert len(ds) == len(jds) > 0
    assert type(ds).__name__ == type(jds).__name__
    for i in range(len(jds)):
        for got, ref in zip(ds[i], jds[i]):
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("name", list(FORMATS))
def test_loader_matches_jax(fixtures, name, size):
    """Each loader, on a fixture in its format: color, depth, intrinsics
    and pose bit for bit equal to the JAX loader's (both decode with their
    native decoders where they build)."""
    _assert_same(*_load_both(fixtures, name, size))


@pytest.mark.parametrize("name", ["replica", "tum", "ai2thor", "realsense"])
def test_python_decode_matches_jax(fixtures, name, monkeypatch):
    """With the native decoder off, the port's Python path (its decoder
    and its numpy resize) gives the JAX loader's bits, resized too."""
    from splatam_torch.data import base

    monkeypatch.setattr(base, "_NATIVE_DECODER", False)
    for size in SIZES:
        _assert_same(*_load_both(fixtures, name, size))


def test_resize_against_cv2():
    """The numpy resize against OpenCV, the JAX loader's Python path: equal
    at the native size, at half size and for nearest; bilinear at other
    scales within 2 ulp of 255 (OpenCV's float interpolation rounds
    differently from the float64 convention the native decoder fixes)."""
    import cv2

    from splatam_torch.data.base import resize_linear, resize_nearest

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64, 3)).astype(np.float32)
    dep = rng.integers(0, 65536, (48, 64)).astype(np.float32)
    for h, w in [(48, 64), (24, 32), (30, 40), (17, 23), (96, 128)]:
        ref = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        got = resize_linear(img, h, w)
        if (h, w) in [(48, 64), (24, 32)]:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=255 * 2.0**-22)
        np.testing.assert_array_equal(
            resize_nearest(dep, h, w),
            cv2.resize(dep, (w, h), interpolation=cv2.INTER_NEAREST))


def test_dataset_configs_match_jax(tmp_path):
    """load_dataset_config equals the JAX (PyYAML) one on every YAML under
    configs/data/ and through inherit_from."""
    from splatam_tpu.data import load_dataset_config as jload

    from splatam_torch.data import load_dataset_config

    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "data", "**",
                                          "*.yaml"), recursive=True))
    assert len(paths) >= 9
    base = tmp_path / "base.yaml"
    base.write_text("dataset_name: 'replica'  # comment\ncamera_params:\n"
                    "  fx: 100.0\n  fy: 1e-3\n  crop_edge: 0\n"
                    "  distortion: ~\n  flag: yes\n")
    child = tmp_path / "child.yaml"
    child.write_text(f"inherit_from: {base}\ncamera_params:\n  fx: 200\n"
                     "  cy: -.5\nname: \"room 0\"\n")
    for p in paths + [str(child)]:
        got, ref = load_dataset_config(p), jload(p)
        assert got == ref and repr(got) == repr(ref), p
    assert load_dataset_config(str(child))["camera_params"]["fy"] == "1e-3"


def test_prefetch_loader_order(fixtures):
    from splatam_torch.data import PrefetchLoader

    ds, _ = _load_both(fixtures, "tum", "native")
    frames = list(PrefetchLoader(ds, lookahead=2))
    assert len(frames) == len(ds)
    for i, frame in enumerate(frames):
        for a, b in zip(frame, ds[i]):
            np.testing.assert_array_equal(a, b)


def test_native_decoder_matches_python(fixtures):
    """The port's native decoder (built into build/native/) against the
    Python decode and numpy resize, resized."""
    from splatam_torch.data import base
    from splatam_torch.native import NativeFrameDecoder, native_available

    if not native_available():
        pytest.skip("no native loader")
    for name in ("replica", "ai2thor"):
        ds, _ = _load_both(fixtures, name, "resized")
        assert ds._load_native(0) is not None
        native = ds[1]
        ds._load_native = lambda i: None
        for a, b in zip(native, ds[1]):
            np.testing.assert_array_equal(a, b)
    path = glob.glob(str(fixtures["replica"][0] / "room0" / "results" / "*.png"))[0]
    assert NativeFrameDecoder().png_info(path) == (H, W, 1, 16)
    assert os.path.dirname(base._native_decoder().lib._name).endswith(
        os.path.join("build", "native"))


@pytest.mark.parametrize("decoder", ["PIL", None])
def test_imread_without_imageio(fixtures, monkeypatch, decoder):
    """Without imageio the loaders decode with Pillow (imageio's backend)
    to the same arrays; without Pillow either, a decode raises and names
    both."""
    from splatam_torch.data import base

    monkeypatch.setattr(base, "_NATIVE_DECODER", False)  # Python path only
    names = ["tum", "ai2thor", "replica", "realsense"]
    refs = {n: _load_both(fixtures, n, "resized")[0] for n in names}
    monkeypatch.setattr(base, "IMREAD_DECODER", decoder)
    if decoder is None:
        with pytest.raises(ImportError, match="neither imageio nor Pillow"):
            refs["replica"][0]
        return
    for n in names:
        _assert_same(_load_both(fixtures, n, "resized")[0], refs[n])
