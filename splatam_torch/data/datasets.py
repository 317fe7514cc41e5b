"""Concrete RGB-D sequence loaders.

The port's copy of ``splatam_tpu/data/datasets.py``: the reference's 12
on-disk dataset formats (`datasets/gradslam_datasets/*.py`); each class
documents its file layout and pose convention with a citation into the
reference. All are host-side numpy, with the JAX loaders' file formats,
association rules and pose conventions.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict

import numpy as np

from splatam_torch.data.base import RGBDDataset, natsorted

_FLIP_YZ = np.diag([1.0, -1.0, -1.0, 1.0])  # OpenGL -> OpenCV camera axes


def _pose_from_quat(pvec: np.ndarray) -> np.ndarray:
    """[tx ty tz qx qy qz qw] -> 4x4 c2w (`tum.py:118-125`)."""
    from scipy.spatial.transform import Rotation

    pose = np.eye(4)
    pose[:3, :3] = Rotation.from_quat(pvec[3:]).as_matrix()
    pose[:3, 3] = pvec[:3]
    return pose


class ReplicaDataset(RGBDDataset):
    """Replica (NICE-SLAM capture): results/frame*.jpg + depth*.png,
    row-major 4x4 c2w per line in traj.txt (`replica.py:13-67`)."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = os.path.join(self.input_folder, "traj.txt")
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        depth = natsorted(glob.glob(f"{self.input_folder}/results/depth*.png"))
        return color, depth

    def load_poses(self):
        with open(self.pose_path) as f:
            lines = f.readlines()
        return [
            np.array(list(map(float, lines[i].split()))).reshape(4, 4)
            for i in range(self.num_imgs)
        ]


class ReplicaV2Dataset(RGBDDataset):
    """Replica-V2 iMAP splits: imap/00 train, imap/01 test; NVS eval
    prepends the first train frame (`replica.py:69-148`)."""

    def __init__(self, config_dict, basedir, sequence, use_train_split=True, **kwargs):
        self.use_train_split = use_train_split
        if use_train_split:
            self.input_folder = os.path.join(basedir, sequence, "imap/00")
            self.pose_path = os.path.join(self.input_folder, "traj_w_c.txt")
        else:
            self.train_input_folder = os.path.join(basedir, sequence, "imap/00")
            self.train_pose_path = os.path.join(
                self.train_input_folder, "traj_w_c.txt"
            )
            self.input_folder = os.path.join(basedir, sequence, "imap/01")
            self.pose_path = os.path.join(self.input_folder, "traj_w_c.txt")
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color = natsorted(glob.glob(f"{self.input_folder}/rgb/rgb_*.png"))
        depth = natsorted(glob.glob(f"{self.input_folder}/depth/depth_*.png"))
        if not self.use_train_split:
            color = [f"{self.train_input_folder}/rgb/rgb_0.png"] + color
            depth = [f"{self.train_input_folder}/depth/depth_0.png"] + depth
        return color, depth

    def load_poses(self):
        poses = []
        if not self.use_train_split:
            with open(self.train_pose_path) as f:
                first = f.readlines()[0]
            poses.append(np.array(list(map(float, first.split()))).reshape(4, 4))
        with open(self.pose_path) as f:
            lines = f.readlines()
        n = self.num_imgs if self.use_train_split else self.num_imgs - 1
        poses += [
            np.array(list(map(float, lines[i].split()))).reshape(4, 4)
            for i in range(n)
        ]
        return poses


class TUMDataset(RGBDDataset):
    """TUM RGB-D: timestamped rgb.txt/depth.txt/groundtruth.txt association
    at max_dt 0.08s + 32 Hz subsampling (`tum.py:50-163`)."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        super().__init__(config_dict, **kwargs)

    def _associations(self):
        def parse(path, skiprows=0):
            return np.loadtxt(path, delimiter=" ", dtype=np.str_, skiprows=skiprows)

        pose_list = os.path.join(self.input_folder, "groundtruth.txt")
        if not os.path.isfile(pose_list):
            pose_list = os.path.join(self.input_folder, "pose.txt")
        image_data = parse(os.path.join(self.input_folder, "rgb.txt"))
        depth_data = parse(os.path.join(self.input_folder, "depth.txt"))
        pose_data = parse(pose_list, skiprows=1)
        t_img = image_data[:, 0].astype(np.float64)
        t_dep = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)

        assoc = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_dep - t))
            k = np.argmin(np.abs(t_pose - t))
            if abs(t_dep[j] - t) < 0.08 and abs(t_pose[k] - t) < 0.08:
                assoc.append((i, j, k))
        # 32 Hz frame-rate subsample (`tum.py:100-105`)
        keep = [0]
        for i in range(1, len(assoc)):
            if t_img[assoc[i][0]] - t_img[assoc[keep[-1]][0]] > 1.0 / 32:
                keep.append(i)
        assoc = [assoc[i] for i in keep]
        return image_data, depth_data, pose_data, assoc

    def get_filepaths(self):
        image_data, depth_data, _, assoc = self._associations()
        color = [os.path.join(self.input_folder, image_data[i, 1]) for i, _, _ in assoc]
        depth = [os.path.join(self.input_folder, depth_data[j, 1]) for _, j, _ in assoc]
        return color, depth

    def load_poses(self):
        _, _, pose_data, assoc = self._associations()
        vecs = pose_data[:, 1:].astype(np.float64)
        return [_pose_from_quat(vecs[k]) for _, _, k in assoc]


class ScannetDataset(RGBDDataset):
    """ScanNet exports: color/*.jpg, depth/*.png, pose/*.txt 4x4 c2w
    (`scannet.py`)."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        return (
            natsorted(glob.glob(f"{self.input_folder}/color/*.jpg")),
            natsorted(glob.glob(f"{self.input_folder}/depth/*.png")),
        )

    def load_poses(self):
        return [
            np.loadtxt(p)
            for p in natsorted(glob.glob(f"{self.input_folder}/pose/*.txt"))
        ]


class Ai2thorDataset(RGBDDataset):
    """AI2-THOR sim captures: color/*.png, depth/*.png, pose/*.txt
    (`ai2thor.py`)."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        return (
            natsorted(glob.glob(f"{self.input_folder}/color/*.png")),
            natsorted(glob.glob(f"{self.input_folder}/depth/*.png")),
        )

    def load_poses(self):
        return [
            np.loadtxt(p)
            for p in natsorted(glob.glob(f"{self.input_folder}/pose/*.txt"))
        ]


class ICLDataset(RGBDDataset):
    """ICL-NUIM: rgb/ + depth/ pngs, *.gt.sim pose file with three 4-float
    rows per frame (`icl.py:32-86`)."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        matches = glob.glob(os.path.join(self.input_folder, "*.gt.sim"))
        if not matches:
            raise ValueError(f"Need pose file ending in .gt.sim in {self.input_folder}")
        self.pose_path = matches[0]
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        return (
            natsorted(glob.glob(f"{self.input_folder}/rgb/*.png")),
            natsorted(glob.glob(f"{self.input_folder}/depth/*.png")),
        )

    def load_poses(self):
        rows = []
        with open(self.pose_path) as f:
            for line in f:
                vals = line.strip().split()
                if vals:
                    rows.append(np.array([float(v) for v in vals[:4]]))
        rows = np.stack(rows)
        poses = []
        for i in range(0, rows.shape[0], 3):
            pose = np.zeros((4, 4))
            # bottom-right set to 3 in the reference (`icl.py:76-81`); kept
            # verbatim — relative_transformation normalizes it away.
            pose[3, 3] = 3
            pose[0], pose[1], pose[2] = rows[i], rows[i + 1], rows[i + 2]
            poses.append(pose)
        return poses


class AzureKinectDataset(RGBDDataset):
    """Azure Kinect captures: color/*.jpg + depth/*.png; odometry either
    absent (identity), .log format (5 lines/frame) or flat 16-float lines
    (`azure.py:30-110`)."""

    def __init__(self, config_dict, basedir, sequence, odomfile=None, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = (
            os.path.join(self.input_folder, odomfile) if odomfile else None
        )
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        return (
            natsorted(glob.glob(f"{self.input_folder}/color/*.jpg")),
            natsorted(glob.glob(f"{self.input_folder}/depth/*.png")),
        )

    def load_poses(self):
        if self.pose_path is None:
            print("WARNING: Dataset does not contain poses. Returning identity transform.")
            return [np.eye(4) for _ in range(self.num_imgs)]
        with open(self.pose_path) as f:
            lines = [l for l in f.readlines() if l.split()]
        poses = []
        if self.pose_path.endswith(".log"):
            if len(lines) % 5 != 0:
                raise ValueError(
                    "Incorrect .log odom file: non-empty lines must be a multiple of 5"
                )
            for i in range(len(lines) // 5):
                rows = [list(map(float, lines[5 * i + r].split())) for r in (1, 2, 3, 4)]
                poses.append(np.array(rows).reshape(4, 4))
        else:
            for line in lines:
                poses.append(np.array(list(map(float, line.split()))).reshape(4, 4))
        return poses


class Record3DDataset(RGBDDataset):
    """Record3D (preprocessed): rgb/*.png + depth/*.png + poses/*.npy c2w,
    OpenGL->OpenCV flip P @ c2w @ P^T (`record3d.py:57-69`)."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = os.path.join(self.input_folder, "poses")
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        return (
            natsorted(glob.glob(f"{self.input_folder}/rgb/*.png")),
            natsorted(glob.glob(f"{self.input_folder}/depth/*.png")),
        )

    def load_poses(self):
        return [
            _FLIP_YZ @ np.load(p) @ _FLIP_YZ.T
            for p in natsorted(glob.glob(os.path.join(self.pose_path, "*.npy")))
        ]


class RealsenseDataset(RGBDDataset):
    """Realsense captures via pyrealsense2: rgb/*.jpg + depth/*.png +
    poses/*.npy, same axis flip as Record3D (`realsense.py`)."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = os.path.join(self.input_folder, "poses")
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        return (
            natsorted(glob.glob(f"{self.input_folder}/rgb/*.jpg")),
            natsorted(glob.glob(f"{self.input_folder}/depth/*.png")),
        )

    def load_poses(self):
        return [
            _FLIP_YZ @ np.load(p) @ _FLIP_YZ.T
            for p in natsorted(glob.glob(os.path.join(self.pose_path, "*.npy")))
        ]


def _filepath_index_mapping(frames):
    return {frame["file_path"]: index for index, frame in enumerate(frames)}


class ScannetPPDataset(RGBDDataset):
    """ScanNet++ DSLR captures: NeRFStudio transforms_undistorted.json +
    train_test_lists.json split; poses flipped OpenGL->OpenCV
    (`scannetpp.py:18-141`). Intrinsics come from the json metadata."""

    def __init__(
        self,
        basedir,
        sequence,
        ignore_bad: bool = False,
        use_train_split: bool = True,
        desired_height: int = 1168,
        desired_width: int = 1752,
        **kwargs,
    ):
        self.input_folder = os.path.join(basedir, sequence)
        self.ignore_bad = ignore_bad
        self.use_train_split = use_train_split

        with open(f"{self.input_folder}/dslr/train_test_lists.json") as f:
            split = json.load(f)
        self.image_names = split["train" if use_train_split else "test"]
        if not use_train_split:
            self.train_image_names = split["train"]

        with open(
            f"{self.input_folder}/dslr/nerfstudio/transforms_undistorted.json"
        ) as f:
            meta = json.load(f)
        self.cams_metadata = meta
        if use_train_split:
            self.frames_metadata = meta["frames"]
        else:
            self.frames_metadata = meta["test_frames"]
            self.train_frames_metadata = meta["frames"]
        self.filepath_index_mapping = _filepath_index_mapping(self.frames_metadata)
        if not use_train_split:
            self.train_filepath_index_mapping = _filepath_index_mapping(
                self.train_frames_metadata
            )

        config_dict = {
            "dataset_name": "scannetpp",
            "camera_params": {
                "png_depth_scale": 1000.0,
                "image_height": meta["h"],
                "image_width": meta["w"],
                "fx": meta["fl_x"],
                "fy": meta["fl_y"],
                "cx": meta["cx"],
                "cy": meta["cy"],
            },
        }
        super().__init__(
            config_dict,
            desired_height=desired_height,
            desired_width=desired_width,
            **kwargs,
        )

    def get_filepaths(self):
        base = f"{self.input_folder}/dslr"
        color, depth, self._tmp_poses = [], [], []

        def add(name, frame_meta):
            color.append(f"{base}/undistorted_images/{name}")
            depth.append(
                f"{base}/undistorted_depths/{name.replace('.JPG', '.png')}"
            )
            c2w = np.array(frame_meta["transform_matrix"])
            self._tmp_poses.append(_FLIP_YZ @ c2w @ _FLIP_YZ.T)

        if not self.use_train_split:
            first = self.train_image_names[0]
            add(first, self.train_frames_metadata[self.train_filepath_index_mapping[first]])
        for name in self.image_names:
            fm = self.frames_metadata[self.filepath_index_mapping[name]]
            if self.ignore_bad and fm.get("is_bad"):
                continue
            add(name, fm)
        return color, depth

    def load_poses(self):
        return self._tmp_poses


class NeRFCaptureDataset(RGBDDataset):
    """NeRFCapture iPhone app dumps: rgb/ + depth/ + transforms.json,
    depth scale 6553.5 (`nerfcapture.py:18-135`)."""

    def __init__(
        self,
        basedir,
        sequence,
        desired_height: int = 1440,
        desired_width: int = 1920,
        **kwargs,
    ):
        self.input_folder = os.path.join(basedir, sequence)
        with open(f"{self.input_folder}/transforms.json") as f:
            meta = json.load(f)
        self.cams_metadata = meta
        self.frames_metadata = meta["frames"]
        self.filepath_index_mapping = _filepath_index_mapping(self.frames_metadata)
        self.image_names = [
            f"rgb/{n}" for n in natsorted(os.listdir(f"{self.input_folder}/rgb"))
        ]
        config_dict = {
            "dataset_name": "nerfcapture",
            "camera_params": {
                "png_depth_scale": 6553.5,
                "image_height": meta["h"],
                "image_width": meta["w"],
                "fx": meta["fl_x"],
                "fy": meta["fl_y"],
                "cx": meta["cx"],
                "cy": meta["cy"],
            },
        }
        super().__init__(
            config_dict,
            desired_height=desired_height,
            desired_width=desired_width,
            **kwargs,
        )

    def get_filepaths(self):
        color, depth, self._tmp_poses = [], [], []
        for name in self.image_names:
            fm = self.frames_metadata[self.filepath_index_mapping[name]]
            color.append(f"{self.input_folder}/{name}")
            depth.append(f"{self.input_folder}/{name.replace('rgb', 'depth')}")
            c2w = np.array(fm["transform_matrix"])
            self._tmp_poses.append(_FLIP_YZ @ c2w @ _FLIP_YZ.T)
        return color, depth

    def load_poses(self):
        return self._tmp_poses


class HabitatDataset(RGBDDataset):
    """Habitat-sim stream dumps in TUM-style list format with a
    camera-to-optical axis rotation baked into the quaternion
    (`habitat.py:13-155`)."""

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        super().__init__(config_dict, **kwargs)

    def _pose_from_quat(self, pvec):
        from scipy.spatial.transform import Rotation

        cam2optical = Rotation.from_euler("ZYX", [-np.pi / 2.0, 0.0, -np.pi / 2.0])
        pose = np.eye(4)
        pose[:3, :3] = (Rotation.from_quat(pvec[3:]) * cam2optical).as_matrix()
        pose[:3, 3] = pvec[:3]
        return pose

    def _associations(self):
        def parse(path, skiprows=0):
            return np.loadtxt(path, delimiter=" ", dtype=np.str_, skiprows=skiprows)

        image_data = parse(os.path.join(self.input_folder, "rgb.txt"))
        depth_data = parse(os.path.join(self.input_folder, "depth.txt"))
        pose_data = parse(os.path.join(self.input_folder, "pose.txt"), skiprows=1)
        t_img = image_data[:, 0].astype(np.float64)
        t_dep = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_dep - t))
            k = np.argmin(np.abs(t_pose - t))
            if abs(t_dep[j] - t) < 0.08 and abs(t_pose[k] - t) < 0.08:
                assoc.append((i, j, k))
        keep = [0]
        for i in range(1, len(assoc)):
            if t_img[assoc[i][0]] - t_img[assoc[keep[-1]][0]] > 1.0 / 32:
                keep.append(i)
        return image_data, depth_data, pose_data, [assoc[i] for i in keep]

    def get_filepaths(self):
        image_data, depth_data, _, assoc = self._associations()
        color = [os.path.join(self.input_folder, image_data[i, 1]) for i, _, _ in assoc]
        depth = [os.path.join(self.input_folder, depth_data[j, 1]) for _, j, _ in assoc]
        return color, depth

    def load_poses(self):
        _, _, pose_data, assoc = self._associations()
        vecs = pose_data[:, 1:].astype(np.float64)
        return [self._pose_from_quat(vecs[k]) for _, _, k in assoc]


def get_dataset(config_dict: Dict, basedir: str, sequence: str, **kwargs):
    """Dataset dispatch by name (`scripts/splatam.py:44-70`)."""
    name = config_dict["dataset_name"].lower()
    table = {
        ("icl",): ICLDataset,
        ("replica",): ReplicaDataset,
        ("replicav2",): ReplicaV2Dataset,
        ("azure", "azurekinect"): AzureKinectDataset,
        ("scannet",): ScannetDataset,
        ("ai2thor",): Ai2thorDataset,
        ("record3d",): Record3DDataset,
        ("realsense",): RealsenseDataset,
        ("tum",): TUMDataset,
        ("habitat",): HabitatDataset,
    }
    for names, cls in table.items():
        if name in names:
            return cls(config_dict, basedir, sequence, **kwargs)
    if name == "scannetpp":
        return ScannetPPDataset(basedir, sequence, **kwargs)
    if name == "nerfcapture":
        return NeRFCaptureDataset(basedir, sequence, **kwargs)
    raise ValueError(f"Unknown dataset name {config_dict['dataset_name']}")
