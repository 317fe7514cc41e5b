"""Reconstruction viewers and experiment plots (``splatam_tpu/viz``)."""
from splatam_torch.viz.recon import (
    interactive_online_recon,
    interactive_recon,
    online_replay,
    plot_trajectory,
    render_trajectory,
    rgbd2pcd,
)

__all__ = [
    "render_trajectory",
    "online_replay",
    "plot_trajectory",
    "rgbd2pcd",
    "interactive_recon",
    "interactive_online_recon",
]
