"""Gaussian map parameters on growing tensors.

Counterpart of ``splatam_tpu/core/params.py``. The JAX package keeps the map
in capacity-padded arrays with an active mask; here, as in the CUDA
reference, the tensors hold exactly the live Gaussians: append is
``torch.cat`` and pruning is boolean-mask removal. ``params_from_numpy`` /
``params_to_numpy`` carry maps across the two packages.

Schema: means3D (N,3), rgb_colors (N,3), unnorm_rotations (N,4) wxyz,
logit_opacities (N,1), log_scales (N,1|3), cam_unnorm_rots (1,4,F),
cam_trans (1,3,F). Variables: max_2D_radius, means2D_gradient_accum, denom,
timestep, each (N,).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from splatam_torch.device import resolve_device

GAUSSIAN_KEYS = (
    "means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales"
)
CAMERA_KEYS = ("cam_unnorm_rots", "cam_trans")
VARIABLE_KEYS = ("max_2D_radius", "means2D_gradient_accum", "denom", "timestep")

Params = Dict[str, torch.Tensor]
Variables = Dict[str, torch.Tensor]


def gaussian_values(
    pt_cld: np.ndarray,  # (M, 6) xyz + rgb
    mean3_sq_dist: np.ndarray,  # (M,)
    gaussian_distribution: str,
) -> Dict[str, np.ndarray]:
    """Initial per-Gaussian values (`scripts/splatam.py:126-163`)."""
    if gaussian_distribution not in ("isotropic", "anisotropic"):
        raise ValueError(f"Unknown gaussian_distribution {gaussian_distribution}")
    m = pt_cld.shape[0]
    scale_dim = 1 if gaussian_distribution == "isotropic" else 3
    log_scales = np.tile(
        np.log(np.sqrt(np.maximum(mean3_sq_dist, 1e-12)))[:, None], (1, scale_dim)
    )
    return {
        "means3D": pt_cld[:, :3],
        "rgb_colors": pt_cld[:, 3:6],
        "unnorm_rotations": np.tile([1, 0, 0, 0], (m, 1)),
        "logit_opacities": np.zeros((m, 1)),
        "log_scales": log_scales,
    }


def _tensor(x, dev) -> torch.Tensor:
    # a copy: leaves may be read-only views (JAX arrays, npz members), or
    # tensors on any device
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev, torch.float32, copy=True)
    return torch.as_tensor(np.array(x, np.float32), device=dev)


def initialize_params(
    init_pt_cld: np.ndarray,
    num_frames: int,
    mean3_sq_dist: np.ndarray,
    gaussian_distribution: str = "isotropic",
    device=None,
) -> Tuple[Params, Variables]:
    dev = resolve_device(device)
    vals = gaussian_values(init_pt_cld, mean3_sq_dist, gaussian_distribution)
    params = {k: _tensor(v, dev) for k, v in vals.items()}
    params["cam_unnorm_rots"] = _tensor(
        np.tile(np.array([1, 0, 0, 0], np.float32)[None, :, None],
                (1, 1, num_frames)), dev
    )
    params["cam_trans"] = torch.zeros((1, 3, num_frames), device=dev)
    m = init_pt_cld.shape[0]
    variables = {k: torch.zeros(m, device=dev) for k in VARIABLE_KEYS}
    return params, variables


def get_pose(params: Params, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cam_unnorm_rot (4,), cam_tran (3,)) at frame ``t`` (copies)."""
    return (params["cam_unnorm_rots"][0, :, t].clone(),
            params["cam_trans"][0, :, t].clone())


def set_pose(params: Params, t: int, rot: torch.Tensor, tran: torch.Tensor) -> None:
    """Write a pose into the trajectory tensors, in place."""
    with torch.no_grad():
        params["cam_unnorm_rots"][0, :, t] = rot.reshape(4)
        params["cam_trans"][0, :, t] = tran.reshape(3)


def num_gaussians(params: Params) -> int:
    return params["means3D"].shape[0]


def append_gaussians(
    params: Params,
    variables: Variables,
    new_values: Dict[str, np.ndarray | torch.Tensor],
    time_idx: int,
) -> Tuple[Params, Variables]:
    """Concatenate new Gaussians (`scripts/splatam.py:417-426`): the 2D
    statistics restart at zero for every Gaussian; the new ones get
    ``time_idx`` as their timestep."""
    dev = params["means3D"].device
    m = int(new_values["means3D"].shape[0])
    params = dict(params)
    for k in GAUSSIAN_KEYS:
        params[k] = torch.cat([params[k], _tensor(new_values[k], dev)])
    n = num_gaussians(params)
    timestep = torch.cat([variables["timestep"],
                          torch.full((m,), float(time_idx), device=dev)])
    variables = {k: torch.zeros(n, device=dev) for k in VARIABLE_KEYS}
    variables["timestep"] = timestep
    return params, variables


def remove_gaussians(
    params: Params, variables: Variables, keep: torch.Tensor
) -> Tuple[Params, Variables]:
    """Keep the rows where ``keep`` is true (`utils/slam_external.py:139-160`)."""
    params = dict(params)
    for k in GAUSSIAN_KEYS:
        params[k] = params[k][keep]
    variables = {k: v[keep] for k, v in variables.items()}
    return params, variables


def params_from_numpy(
    params_np: Dict[str, np.ndarray],
    variables_np: Dict[str, np.ndarray] | None = None,
    device=None,
) -> Tuple[Params, Variables]:
    """The JAX package's capacity-padded params (and ``variables``, whose
    ``active`` mask selects the live slots) -> compact tensors. Leaves may
    be numpy arrays or anything ``np.asarray`` takes, e.g. JAX arrays or the
    arrays of a ``params.npz``."""
    dev = resolve_device(device)
    cap = np.asarray(params_np["means3D"]).shape[0]
    active = np.ones(cap, bool)
    if variables_np is not None and "active" in variables_np:
        active = np.asarray(variables_np["active"]).astype(bool)
    params = {k: _tensor(np.asarray(params_np[k])[active], dev)
              for k in GAUSSIAN_KEYS}
    for k in CAMERA_KEYS:
        if k in params_np:
            params[k] = _tensor(params_np[k], dev)
    variables = {}
    for k in VARIABLE_KEYS:
        if variables_np is not None and k in variables_np:
            variables[k] = _tensor(np.asarray(variables_np[k])[active], dev)
        else:
            variables[k] = torch.zeros(int(active.sum()), device=dev)
    return params, variables


def params_to_numpy(
    params: Params, variables: Variables, capacity: int | None = None
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Compact tensors -> capacity-padded numpy params and variables (with
    the ``active`` mask) in the JAX package's layout."""
    n = num_gaussians(params)
    cap = max(capacity or n, n)
    out = {}
    for k, v in params.items():
        a = v.detach().cpu().numpy()
        if k in GAUSSIAN_KEYS:
            pad = np.zeros((cap,) + a.shape[1:], np.float32)
            pad[:n] = a
            a = pad
        out[k] = a
    var = {}
    for k, v in variables.items():
        pad = np.zeros(cap, np.float32)
        pad[:n] = v.detach().cpu().numpy()
        var[k] = pad
    active = np.zeros(cap, bool)
    active[:n] = True
    var["active"] = active
    return out, var
