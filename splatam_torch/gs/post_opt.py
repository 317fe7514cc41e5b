"""Post-SplaTAM map refinement.

Counterpart of ``splatam_tpu/gs/post_opt.py`` (`scripts/post_splatam_opt.py:
68-108,160-262`): start the Gaussian map from a saved SplaTAM checkpoint
(``params.npz``), keep the estimated camera trajectory fixed, and run the
offline-3DGS optimization (random-frame sampling, Inria densification) on
top.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from splatam_torch.core.params import Params, Variables, get_pose
from splatam_torch.core.transforms import pose_to_w2c
from splatam_torch.gs.offline import offline_splatting
from splatam_torch.slam.pipeline import SlamState
from splatam_torch.utils.checkpoint import params_from_checkpoint


@torch.no_grad()
def initialize_from_checkpoint(
    ckpt: Dict[str, np.ndarray], num_frames: int, device=None
) -> Tuple[Params, Variables, np.ndarray]:
    """(params, variables, estimated (F, 4, 4) w2c trajectory) from the
    members of a params.npz (`post_splatam_opt.py:68-108`)."""
    params, variables = params_from_checkpoint(ckpt, device)
    frames = min(num_frames, params["cam_trans"].shape[-1])
    est_w2c = np.stack([
        pose_to_w2c(*get_pose(params, t)).cpu().numpy() for t in range(frames)
    ])
    return params, variables, est_w2c


def post_splatam_opt(config: Dict, dataset, ckpt: Dict[str, np.ndarray],
                     progress: bool = True, device=None) -> SlamState:
    """Refine a SplaTAM map with its estimated trajectory held fixed, on
    ``device`` (None means CUDA; raises when CUDA is absent)."""
    num_frames = config["data"].get("num_frames", -1)
    if num_frames == -1:
        num_frames = len(dataset)
    params, variables, est_w2c = initialize_from_checkpoint(
        ckpt, num_frames, device)
    return offline_splatting(
        config, dataset, progress=progress, initial=(params, variables),
        use_poses=est_w2c, device=device,
    )
