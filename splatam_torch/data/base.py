"""RGB-D sequence dataset base class.

The port's copy of ``splatam_tpu/data/base.py`` (the reference's
GradSLAMDataset, `datasets/gradslam_datasets/basedataset.py:105-341`): each
item is ``(color HxWx3 float32 [0..255], depth HxWx1 float32 meters,
intrinsics 4x4, c2w pose 4x4 relative to frame 0)``, as numpy arrays; the
SLAM loop moves them to the device (``slam/pipeline.as_frame``).

It needs no OpenCV unless a config sets ``distortion``:

* Resizing is numpy, in the arithmetic of ``native/frame_loader.cpp``:
  bilinear for color (``src = (dst + 0.5) * scale - 0.5``, in float64, then
  float32) and nearest for depth (``src = floor(dst * scale)``). Where the
  JAX loader decodes with that library it gives the same bits; OpenCV's
  float bilinear, the JAX loader's other path, is within 2 ulp of it.
* Image files decode with imageio, as the JAX package does, or else with
  Pillow, imageio's own backend for JPEG and PNG (the same arrays); the
  import picks one (``IMREAD_DECODER``), and without either a decode
  raises. ``imwrite``, which the evaluation and the viewers write their
  PNGs with, uses the same library.
* ``RGBDDataset`` tries the native decoder first for each frame (decode and
  resize in C++ with the GIL released), as the JAX loader does.
"""
from __future__ import annotations

import abc
import importlib.util
import os
import re
from typing import Dict, List, Optional

import numpy as np

def natsorted(paths):
    """Natural sort (numeric-aware), replacing the natsort dependency."""

    def key(s):
        return [
            int(tok) if tok.isdigit() else tok
            for tok in re.split(r"(\d+)", os.fspath(s))
        ]

    return sorted(paths, key=key)


def as_intrinsics_matrix(intrinsics) -> np.ndarray:
    """[fx, fy, cx, cy] -> 3x3 K (`basedataset.py:44-53`)."""
    k = np.eye(3)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = intrinsics
    return k


def scale_intrinsics(k: np.ndarray, h_ratio: float, w_ratio: float) -> np.ndarray:
    """Rescale K for a resized image (`datautils.py:73-`)."""
    k = k.copy()
    k[0, 0] *= w_ratio  # fx
    k[1, 1] *= h_ratio  # fy
    k[0, 2] *= w_ratio  # cx
    k[1, 2] *= h_ratio  # cy
    return k


def relative_transformation(t1: np.ndarray, t2: np.ndarray) -> np.ndarray:
    """t1^-1 @ t2 (`geometryutils.py:413-`): pose of t2 in t1's frame."""
    return np.linalg.inv(t1) @ t2


# --- resizing ---------------------------------------------------------------

def _linear_taps(src: int, dst: int):
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    wt = f - i0
    return np.maximum(i0, 0), np.minimum(i0 + 1, src - 1), wt


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of (H, W[, C]) to float32 (`frame_loader.cpp`'s
    ``resize_bilinear``; OpenCV's INTER_LINEAR convention)."""
    sh, sw = img.shape[:2]
    if (sh, sw) == (height, width):
        return img.astype(np.float32)
    y0, y1, wy = _linear_taps(sh, height)
    x0, x1, wx = _linear_taps(sw, width)
    tail = (None,) * (img.ndim - 2)
    wy = wy[(slice(None), None) + tail]
    wx = wx[(None, slice(None)) + tail]
    s = img.astype(np.float64)
    r0, r1 = s[y0], s[y1]
    # the C++ expression, in its order of evaluation
    out = (r0[:, x0] * (1 - wy) * (1 - wx) + r0[:, x1] * (1 - wy) * wx
           + r1[:, x0] * wy * (1 - wx) + r1[:, x1] * wy * wx)
    return out.astype(np.float32)


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest resize of (H, W[, C]) to float32 (``resize_nearest``;
    OpenCV's INTER_NEAREST convention)."""
    sh, sw = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(height) * (sh / height)).astype(np.int64),
                    sh - 1)
    xs = np.minimum(np.floor(np.arange(width) * (sw / width)).astype(np.int64),
                    sw - 1)
    return img[ys][:, xs].astype(np.float32)


# --- decoding ---------------------------------------------------------------

_NATIVE_DECODER = None


def _native_decoder():
    """The native frame decoder (built on first use), or None where it does
    not build."""
    global _NATIVE_DECODER
    if _NATIVE_DECODER is None:
        try:
            from splatam_torch.native import NativeFrameDecoder

            _NATIVE_DECODER = NativeFrameDecoder()
        except Exception:
            _NATIVE_DECODER = False
    return _NATIVE_DECODER or None


def _installed_decoder() -> Optional[str]:
    for module in ("imageio", "PIL"):
        if importlib.util.find_spec(module) is not None:
            return module
    return None


# "imageio", "PIL", or None where neither is installed
IMREAD_DECODER = _installed_decoder()


def _imread(path: str) -> np.ndarray:
    """Decode an image file with ``IMREAD_DECODER``: uint8 color, uint16
    depth, as imageio returns them."""
    if IMREAD_DECODER == "imageio":
        import imageio.v2 as imageio

        return np.asarray(imageio.imread(path))
    if IMREAD_DECODER == "PIL":
        from PIL import Image

        with Image.open(path) as img:
            return np.asarray(img)
    raise ImportError(f"cannot decode {path}: neither imageio nor Pillow is "
                      "installed")


def imwrite(path: str, img: np.ndarray) -> None:
    """Write ``img`` (uint8 (H, W, 3) RGB or uint16 (H, W) gray) to the
    image file ``path`` names, with ``IMREAD_DECODER``'s library: the files
    hold the same pixels either way."""
    if IMREAD_DECODER == "imageio":
        import imageio.v2 as imageio

        imageio.imwrite(path, img)
        return
    if IMREAD_DECODER == "PIL":
        from PIL import Image

        Image.fromarray(img).save(path)
        return
    raise ImportError(f"cannot write {path}: neither imageio nor Pillow is "
                      "installed")


def _read_exr_depth(path: str) -> np.ndarray:
    """EXR depth (`basedataset.py:69-102`); needs the OpenEXR package."""
    try:
        import OpenEXR  # type: ignore
        import Imath  # type: ignore
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            "EXR depth requires the OpenEXR package (not installed)"
        ) from e
    f = OpenEXR.InputFile(path)
    dw = f.header()["dataWindow"]
    size = (dw.max.y - dw.min.y + 1, dw.max.x - dw.min.x + 1)
    raw = f.channel("Y", Imath.PixelType(Imath.PixelType.FLOAT))
    return np.frombuffer(raw, np.float32).reshape(size)


class RGBDDataset(abc.ABC):
    """Base loader: path listing and pose loading live in subclasses."""

    def __init__(
        self,
        config_dict: Dict,
        stride: Optional[int] = 1,
        start: int = 0,
        end: int = -1,
        desired_height: int = 480,
        desired_width: int = 640,
        normalize_color: bool = False,
        channels_first: bool = False,
        relative_pose: bool = True,
        **kwargs,
    ):
        self.name = config_dict["dataset_name"]
        cam = config_dict["camera_params"]
        self.png_depth_scale = cam["png_depth_scale"]
        self.orig_height = cam["image_height"]
        self.orig_width = cam["image_width"]
        self.fx, self.fy = cam["fx"], cam["fy"]
        self.cx, self.cy = cam["cx"], cam["cy"]
        self.distortion = (
            np.array(cam["distortion"]) if cam.get("distortion") is not None else None
        )
        self.crop_size = cam.get("crop_size")
        self.crop_edge = cam.get("crop_edge")

        self.desired_height = desired_height
        self.desired_width = desired_width
        self.height_ratio = float(desired_height) / self.orig_height
        self.width_ratio = float(desired_width) / self.orig_width
        self.normalize_color = normalize_color
        self.channels_first = channels_first
        self.relative_pose = relative_pose

        if start < 0:
            raise ValueError(f"start must be positive. Got {start}.")
        if not (end == -1 or end > start):
            raise ValueError(f"end ({end}) must be -1 or greater than start ({start})")
        stride = stride or 1

        self.color_paths, self.depth_paths = self.get_filepaths()
        if len(self.color_paths) != len(self.depth_paths):
            raise ValueError("Number of color and depth images must be the same.")
        self.num_imgs = len(self.color_paths)
        poses = self.load_poses()

        if end == -1:
            end = self.num_imgs
        self.color_paths = self.color_paths[start:end:stride]
        self.depth_paths = self.depth_paths[start:end:stride]
        poses = poses[start:end:stride]
        self.retained_inds = np.arange(self.num_imgs)[start:end:stride]
        self.num_imgs = len(self.color_paths)

        poses = np.stack([np.asarray(p, dtype=np.float64) for p in poses])
        if self.relative_pose:
            poses = relative_transformation(
                np.broadcast_to(poses[0], poses.shape), poses
            )
        self.transformed_poses = poses.astype(np.float32)

    def __len__(self) -> int:
        return self.num_imgs

    @abc.abstractmethod
    def get_filepaths(self):
        """Return (color_paths, depth_paths)."""

    @abc.abstractmethod
    def load_poses(self) -> List[np.ndarray]:
        """Return per-frame 4x4 c2w poses."""

    def get_cam_k(self) -> np.ndarray:
        return as_intrinsics_matrix([self.fx, self.fy, self.cx, self.cy])

    def _preprocess_color(self, color: np.ndarray) -> np.ndarray:
        color = resize_linear(color, self.desired_height, self.desired_width)
        if self.normalize_color:
            color = color / 255.0
        return color

    def _preprocess_depth(self, depth: np.ndarray) -> np.ndarray:
        depth = resize_nearest(depth.astype(np.float32), self.desired_height,
                               self.desired_width)
        return depth[..., None] / self.png_depth_scale

    def _load_native(self, index: int):
        """Decode and resize with the native decoder; None where it does
        not apply."""
        dec = _native_decoder()
        if dec is None or self.distortion is not None or self.normalize_color:
            return None
        cpath, dpath = self.color_paths[index], self.depth_paths[index]
        if not dpath.endswith(".png"):
            return None
        try:
            if cpath.lower().endswith((".jpg", ".jpeg")):
                color = dec.jpeg_rgb(cpath, self.desired_height, self.desired_width)
            elif cpath.lower().endswith(".png"):
                color = dec.png(
                    cpath, self.desired_height, self.desired_width, 3,
                    nearest=False,
                )
            else:
                return None
            depth = dec.png(
                dpath, self.desired_height, self.desired_width, 1, nearest=True
            ) / self.png_depth_scale
            return color, depth
        except ValueError:
            return None

    def __getitem__(self, index: int):
        native = self._load_native(index)
        k = self.get_cam_k()
        if native is not None:
            color, depth = native
        else:
            color = _imread(self.color_paths[index]).astype(np.float32)
            depth_path = self.depth_paths[index]
            if depth_path.endswith(".exr"):
                depth = _read_exr_depth(depth_path)
            elif depth_path.endswith(".npy"):
                depth = np.load(depth_path)
            else:
                depth = _imread(depth_path).astype(np.int64)
            if self.distortion is not None:
                try:
                    import cv2
                except ImportError as e:
                    raise ImportError(
                        "camera_params.distortion needs OpenCV (cv2) for "
                        "cv2.undistort, and it is not installed") from e
                # undistortion applies to color only (`basedataset.py:316-318`)
                color = cv2.undistort(color, k, self.distortion)
            color = self._preprocess_color(color)
            depth = self._preprocess_depth(depth)
        k = scale_intrinsics(k, self.height_ratio, self.width_ratio)

        if self.crop_edge is not None and self.crop_edge > 0:
            e = self.crop_edge
            color = color[e:-e, e:-e]
            depth = depth[e:-e, e:-e]
            k = k.copy()
            k[0, 2] -= e
            k[1, 2] -= e

        intrinsics = np.eye(4, dtype=np.float32)
        intrinsics[:3, :3] = k
        pose = self.transformed_poses[index]

        if self.channels_first:
            color = np.transpose(color, (2, 0, 1))
            depth = np.transpose(depth, (2, 0, 1))
        return (
            color.astype(np.float32),
            depth.astype(np.float32),
            intrinsics,
            pose.astype(np.float32),
        )
