"""Reconstruction visualization command-line entry point.

Usage: python -m splatam_torch.run.viz configs/replica/splatam.py
       [--mode color|depth|sil] [--every N] [--interactive]
       [--run_name NAME] [--device cpu]

Counterpart of ``splatam_tpu/run/viz.py`` (`viz_scripts/final_recon.py`,
`online_recon.py`): renders the estimated trajectory of the run's
``params.npz`` to ``recon/recon_%04d.png`` and plots it against the ground
truth in ``trajectory.png`` (where matplotlib imports; else it says so and
plots nothing); ``--interactive`` opens the Open3D view (needs open3d and a
display). Renders on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import os

from splatam_torch.device import resolve_device
from splatam_torch.render.binning import RasterConfig
from splatam_torch.run.common import load_experiment_config, standard_argparser
from splatam_torch.utils.checkpoint import load_params
from splatam_torch.viz import interactive_recon, plot_trajectory, render_trajectory


def main(argv=None):
    """Run the CLI on ``argv``. Returns (the PNGs written, the trajectory
    plot's path or None where matplotlib does not import)."""
    p = standard_argparser("Visualize reconstruction")
    p.add_argument("--mode", default=None, choices=[None, "color", "depth", "sil"])
    p.add_argument("--every", type=int, default=5)
    p.add_argument("--interactive", action="store_true",
                   help="Open3D point-cloud view (needs open3d + display)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    config = load_experiment_config(args.config)
    if args.run_name is not None:
        config["run_name"] = args.run_name
    run_dir = os.path.join(config["workdir"], config["run_name"])

    params, _, extras = load_params(os.path.join(run_dir, "params.npz"),
                                    device=dev)
    intrinsics = extras["intrinsics"][:3, :3]
    first_w2c = extras["w2c"]
    viz_cfg = config.get("viz", {})
    mode = args.mode or viz_cfg.get("render_mode", "color")
    raster_cfg = RasterConfig(**config.get("raster", {}))

    out_dir = os.path.join(run_dir, "recon")
    pngs = render_trajectory(
        params, intrinsics, first_w2c, out_dir,
        width=config["data"]["desired_image_width"],
        height=config["data"]["desired_image_height"],
        raster_cfg=raster_cfg, every=args.every,
        render_mode="sil" if viz_cfg.get("show_sil") else mode, device=dev,
    )
    plot = os.path.join(run_dir, "trajectory.png")
    try:
        plot_trajectory(params, extras.get("gt_w2c_all_frames"), plot)
    except ImportError as e:
        print(f"[warn] no trajectory plot: {e}")
        plot = None
    print(f"wrote {len(pngs)} frames to {out_dir}"
          + (f" and {plot}" if plot else ""))

    if args.interactive:
        interactive_recon(params, intrinsics, first_w2c, viz_cfg, raster_cfg,
                          device=dev)
    return pngs, plot


if __name__ == "__main__":
    main()
