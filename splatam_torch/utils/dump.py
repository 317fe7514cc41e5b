"""Frame-stream dump and replay, the realtime CLI's replay format.

Counterpart of ``splatam_tpu/utils/dump.py`` (the reference's
DUMP_DATA/LOAD_DATA hooks, `utils/plot_utils.py:284-307`): every frame of a
stream as ``frame_{i:06d}.npz`` with color, depth, intrinsics and gt_pose,
so a live run can be replayed offline. The two packages read each other's
dumps.
"""
from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np


def dump_dataset(dataset, out_dir: str) -> None:
    """Write every frame of ``dataset`` ((color, depth, intrinsics, c2w)
    items) as frame_{i:06d}.npz under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    for i in range(len(dataset)):
        color, depth, intrinsics, pose = dataset[i]
        np.savez(
            os.path.join(out_dir, f"frame_{i:06d}.npz"),
            color=np.asarray(color),
            depth=np.asarray(depth),
            intrinsics=np.asarray(intrinsics),
            gt_pose=np.asarray(pose),
        )


class DumpedDataset:
    """Replays a dumped frame stream with the dataset protocol."""

    def __init__(self, dump_dir: str):
        self.paths = sorted(glob.glob(os.path.join(dump_dir, "frame_*.npz")))
        if not self.paths:
            raise FileNotFoundError(f"no frame_*.npz under {dump_dir}")

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, ...]:
        with np.load(self.paths[idx]) as d:
            return d["color"], d["depth"], d["intrinsics"], d["gt_pose"]
