"""Checkpoints in the JAX package's ``params.npz`` format.

Counterpart of ``splatam_tpu/utils/checkpoint.py`` (`save_params`,
`utils/common_utils.py:25-74`): the archive holds the live Gaussians (the
port's tensors hold nothing else; JAX strips its capacity padding on
save), the camera trajectory and their timesteps, all float32, plus the
optional intrinsics, first-frame w2c, ground-truth poses, keyframe indices
and image size, under the same keys and types, so a map saved by either
package loads in the other.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from splatam_torch.core.params import (
    CAMERA_KEYS,
    GAUSSIAN_KEYS,
    VARIABLE_KEYS,
    Params,
    Variables,
)
from splatam_torch.device import resolve_device

EXTRA_KEYS = ("intrinsics", "w2c", "gt_w2c_all_frames",
              "keyframe_time_indices", "org_width", "org_height")


def params_to_numpy(params: Params, variables: Variables) -> Dict[str, np.ndarray]:
    """Every parameter, and the Gaussians' timesteps, as numpy arrays."""
    out = {k: v.detach().cpu().numpy() for k, v in params.items()}
    out["timestep"] = variables["timestep"].detach().cpu().numpy()
    return out


def save_params(
    params: Params,
    variables: Variables,
    output_dir: str,
    *,
    intrinsics: np.ndarray | None = None,
    first_w2c: np.ndarray | None = None,
    gt_w2c_all_frames: List[np.ndarray] | None = None,
    keyframe_time_indices: List[int] | None = None,
    org_width: int | None = None,
    org_height: int | None = None,
    name: str = "params",
) -> str:
    """Write ``output_dir/name.npz``; returns its path."""
    os.makedirs(output_dir, exist_ok=True)
    to_save = params_to_numpy(params, variables)
    if intrinsics is not None:
        to_save["intrinsics"] = np.asarray(intrinsics)
    if first_w2c is not None:
        to_save["w2c"] = np.asarray(first_w2c)
    if gt_w2c_all_frames:
        to_save["gt_w2c_all_frames"] = np.stack(
            [np.asarray(g) for g in gt_w2c_all_frames]
        )
    if keyframe_time_indices is not None:
        to_save["keyframe_time_indices"] = np.array(keyframe_time_indices)
    if org_width is not None:
        to_save["org_width"] = np.array(org_width)
    if org_height is not None:
        to_save["org_height"] = np.array(org_height)
    path = os.path.join(output_dir, name + ".npz")
    np.savez(path, **to_save)
    return path


def save_params_ckpt(params: Params, variables: Variables, output_dir: str,
                     time_idx: int) -> str:
    """The periodic SLAM checkpoint ``output_dir/params{time_idx}.npz``."""
    return save_params(params, variables, output_dir, name=f"params{time_idx}")


def params_from_checkpoint(raw: Dict[str, np.ndarray],
                           device=None) -> Tuple[Params, Variables]:
    """Tensors on ``device`` (None means CUDA) from the members of a params
    npz: the 2D statistics start at zero, the timesteps come from the
    file."""
    dev = resolve_device(device)
    n = np.asarray(raw["means3D"]).shape[0]

    def tensor(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)

    params = {k: tensor(raw[k]) for k in GAUSSIAN_KEYS + CAMERA_KEYS}
    variables = {k: torch.zeros(n, device=dev) for k in VARIABLE_KEYS}
    if "timestep" in raw:
        variables["timestep"] = tensor(raw["timestep"])
    return params, variables


def load_params(path: str, device=None) -> Tuple[Params, Variables, Dict]:
    """Load a params npz (``params_from_checkpoint``). Returns (params,
    variables, extras): ``extras`` holds the members of EXTRA_KEYS that are
    present."""
    dev = resolve_device(device)
    raw = dict(np.load(path, allow_pickle=True))
    params, variables = params_from_checkpoint(raw, dev)
    return params, variables, {k: raw[k] for k in EXTRA_KEYS if k in raw}
