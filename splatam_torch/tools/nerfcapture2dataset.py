"""NeRFCapture (iPhone) stream -> on-disk dataset capture tool.

Counterpart of ``splatam_tpu/tools/nerfcapture2dataset.py``
(`scripts/nerfcapture2dataset.py`): subscribes to the NeRFCapture
CycloneDDS topic and writes rgb/, depth/ and transforms.json in the layout
``data.datasets.NeRFCaptureDataset`` reads. The DDS machinery is
import-gated to ``make_reader()``; the frame decode, the capture loop and
the writers run on anything with ``read_next()``. PNGs are written with
``data/base.imwrite`` (imageio, else Pillow).

Usage: python -m splatam_torch.tools.nerfcapture2dataset --save_path out/ --num_frames 100
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np

from splatam_torch.data.base import imwrite

# CycloneDDS domain config of the reference (`nerfcapture2dataset.py:63-77`):
# big socket buffers for the uncompressed RGB frames
DDS_CONFIG = """<?xml version="1.0" encoding="UTF-8" ?> \
<CycloneDDS xmlns="https://cdds.io/config" xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" xsi:schemaLocation="https://cdds.io/config https://raw.githubusercontent.com/eclipse-cyclonedds/cyclonedds/master/etc/cyclonedds.xsd"> \
    <Domain id="any"> \
        <Internal> \
            <MinimumSocketReceiveBufferSize>10MB</MinimumSocketReceiveBufferSize> \
        </Internal> \
    </Domain> \
</CycloneDDS> \
"""


def init_capture_dir(save_path: str) -> None:
    os.makedirs(os.path.join(save_path, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(save_path, "depth"), exist_ok=True)


def _resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Nearest-neighbour resize (the reference uses cv2.INTER_NEAREST for
    depth; plain index math needs no OpenCV)."""
    sh, sw = img.shape[:2]
    if (sh, sw) == (h, w):
        return img
    yi = (np.arange(h) * sh // h).clip(0, sh - 1)
    xi = (np.arange(w) * sw // w).clip(0, sw - 1)
    return img[yi[:, None], xi[None, :]]


def decode_frame(sample, depth_scale: float = 10.0):
    """NeRFCapture DDS sample -> (rgb u8 HxWx3, depth meters HxW | None, X_WV).

    Mirrors the reference's decode (`nerfcapture2dataset.py:126-143`): the
    RGB payload is a flat uint8 sequence; the depth payload is float32
    meters bitcast into uint8, at its own (depth_width, depth_height)
    resolution, nearest-resized to the RGB resolution. ``depth_scale`` is
    kept for signature parity (the reference folds it into its uint16
    quantization; we return meters and quantize in save_frame).

    transform_matrix arrives flat (16,) COLUMN-major — the reference
    reshapes and TRANSPOSES (`X_WV = ....reshape((4, 4)).T`).
    """
    def _as_u8(x):
        # DDS sequences arrive as lists from cyclonedds; fakes/replays may
        # hand raw bytes — frombuffer covers both without a copy loop
        if isinstance(x, (bytes, bytearray, memoryview)):
            return np.frombuffer(x, dtype=np.uint8)
        return np.asarray(x, dtype=np.uint8)

    w, h = int(sample.width), int(sample.height)
    rgb = _as_u8(sample.image).reshape((h, w, 3))
    depth = None
    if sample.has_depth:
        dw, dh = int(sample.depth_width), int(sample.depth_height)
        depth = _as_u8(sample.depth_image).view(dtype=np.float32).reshape(
            (dh, dw)
        )
        depth = _resize_nearest(depth, w, h)
    x_wv = (
        np.asarray(sample.transform_matrix, dtype=np.float32)
        .reshape((4, 4))
        .T
    )
    return rgb, depth, x_wv


def save_frame(
    save_path: str,
    idx: int,
    rgb: np.ndarray,  # (H, W, 3) uint8
    depth: np.ndarray | None,  # (H, W) float meters, or None
    transform_matrix: np.ndarray,  # (4, 4) c2w (OpenGL convention)
    depth_scale: float = 6553.5,
) -> Dict:
    """Write one frame; returns its transforms.json entry."""
    name = f"rgb/{idx}.png"
    imwrite(os.path.join(save_path, name), rgb)
    entry = {
        "file_path": name,
        "transform_matrix": np.asarray(transform_matrix).tolist(),
    }
    if depth is not None:
        imwrite(
            os.path.join(save_path, f"depth/{idx}.png"),
            (depth * depth_scale).astype(np.uint16),
        )
        entry["depth_path"] = f"depth/{idx}.png"
    return entry


def write_transforms(
    save_path: str, frames: List[Dict], w: int, h: int,
    fl_x: float, fl_y: float, cx: float, cy: float,
    depth_scale: float = 6553.5,
) -> None:
    meta = {
        "w": w, "h": h, "fl_x": fl_x, "fl_y": fl_y, "cx": cx, "cy": cy,
        "integer_depth_scale": 1.0 / depth_scale,
        "frames": frames,
    }
    with open(os.path.join(save_path, "transforms.json"), "w") as f:
        json.dump(meta, f, indent=2)


def make_reader():  # pragma: no cover - requires cyclonedds + a network
    """Build the NeRFCapture DDS reader (topic schema of
    `scripts/nerfcapture2dataset.py:42-60`). Import-gated."""
    from dataclasses import dataclass

    import cyclonedds.idl as idl
    import cyclonedds.idl.annotations as annotate
    import cyclonedds.idl.types as types
    from cyclonedds.core import Policy, Qos
    from cyclonedds.domain import Domain, DomainParticipant
    from cyclonedds.sub import DataReader
    from cyclonedds.topic import Topic
    from cyclonedds.util import duration

    @dataclass
    @annotate.final
    @annotate.autoid("sequential")
    class SplatCaptureFrame(
        idl.IdlStruct, typename="SplatCaptureData.SplatCaptureFrame"
    ):
        id: types.uint32
        annotate.key("id")
        timestamp: types.float64
        fl_x: types.float32
        fl_y: types.float32
        cx: types.float32
        cy: types.float32
        transform_matrix: types.array[types.float32, 16]
        width: types.uint32
        height: types.uint32
        image: types.sequence[types.uint8]
        has_depth: bool
        depth_width: types.uint32
        depth_height: types.uint32
        depth_scale: types.float32
        depth_image: types.sequence[types.uint8]

    domain = Domain(domain_id=0, config=DDS_CONFIG)
    participant = DomainParticipant()
    qos = Qos(Policy.Reliability.Reliable(max_blocking_time=duration(seconds=1)))
    topic = Topic(participant, "Frames", SplatCaptureFrame, qos=qos)
    reader = DataReader(participant, topic)
    # the domain must outlive the reader; hang it off the object
    reader._splatam_domain = domain
    return reader


def dataset_capture_loop(
    reader,
    save_path: str,
    n_frames: int,
    depth_scale: float = 10.0,
    progress: bool = True,
) -> int:
    """Receive ``n_frames`` NeRFCapture frames and write the dataset.

    ``reader`` is anything with `read_next() -> sample | None` (the live
    DataReader, or a mock in tests — `nerfcapture2dataset.py:80-170`).
    Returns the number of frames written. The on-disk uint16 quantization
    uses 65535/depth_scale counts per meter, matching the manifest's
    integer_depth_scale = depth_scale/65535 on the read side.
    """
    total = 0
    frames: List[Dict] = []
    meta = None
    u16_per_m = 65535.0 / float(depth_scale)
    while total < n_frames:
        sample = reader.read_next()
        if not sample:
            continue
        if total == 0:
            init_capture_dir(save_path)
            meta = (
                int(sample.width), int(sample.height),
                float(sample.fl_x), float(sample.fl_y),
                float(sample.cx), float(sample.cy),
            )
        rgb, depth, x_wv = decode_frame(sample, depth_scale)
        frames.append(
            save_frame(save_path, total, rgb, depth, x_wv, u16_per_m)
        )
        total += 1
        if progress:
            print(f"{total}/{n_frames} frames received")
    if meta is not None:
        w, h, fl_x, fl_y, cx, cy = meta
        write_transforms(
            save_path, frames, w, h, fl_x, fl_y, cx, cy, u16_per_m
        )
    return total


def main(argv=None):  # pragma: no cover - requires a CycloneDDS device
    parser = argparse.ArgumentParser()
    parser.add_argument("--save_path", required=True)
    parser.add_argument("--num_frames", type=int, default=100)
    parser.add_argument("--depth_scale", type=float, default=10.0)
    args = parser.parse_args(argv)

    try:
        reader = make_reader()
    except ImportError:
        raise SystemExit(
            "cyclonedds is not installed — the live capture tool needs it. "
            "The decode/capture-loop/writers run without it (see tests)."
        )
    print("Waiting for frames...")
    dataset_capture_loop(
        reader, args.save_path, args.num_frames, args.depth_scale
    )
    print("Done")


if __name__ == "__main__":
    main()
