"""SplaTAM SLAM command-line entry point.

Usage: python -m splatam_torch.run.slam configs/replica/splatam.py
       [--run_name NAME] [--device cpu]

Counterpart of ``splatam_tpu/run/slam.py`` (`scripts/splatam.py:1039-1061`):
load the experiment config, seed, build the dataset (and the tracking and
densification datasets where the config asks for other resolutions), run
SLAM, print the four timing averages, evaluate the final map (saving an
emergency checkpoint if the evaluation fails), and save ``params.npz`` (the
JAX package's format) and ``splat.ply``. Runs on the GPU unless
``--device cpu`` is given.
"""
from __future__ import annotations

import os
import time

import numpy as np

from splatam_torch.device import resolve_device
from splatam_torch.eval.runner import eval_sequence
from splatam_torch.parallel.mesh import maybe_initialize_distributed
from splatam_torch.render.binning import RasterConfig
from splatam_torch.run.common import (
    build_datasets_with_resolutions,
    load_experiment_config,
    prepare_results_dir,
    seed_everything,
    standard_argparser,
)
from splatam_torch.slam.pipeline import rgbd_slam
from splatam_torch.utils.checkpoint import save_params
from splatam_torch.utils.ply import save_ply_from_params


def main(argv=None):
    """Run the CLI on ``argv``. Returns (the final SlamState, the eval
    results, or None where the evaluation failed, with ``eval_s``, its wall
    time)."""
    args = standard_argparser("Run SplaTAM SLAM").parse_args(argv)
    maybe_initialize_distributed(args.device)  # env-gated, as the JAX CLI
    dev = resolve_device(args.device)
    config = load_experiment_config(args.config)
    if args.run_name is not None:
        config["run_name"] = args.run_name
    results_dir = prepare_results_dir(config, args.config)
    seed_everything(config.get("seed", 0))

    dataset, tracking_dataset, densify_dataset = (
        build_datasets_with_resolutions(config)
    )
    state = rgbd_slam(
        config, dataset,
        tracking_dataset=tracking_dataset,
        densify_dataset=densify_dataset,
        device=dev,
    )

    # the reference's four headline timing averages
    # (`scripts/splatam.py:959-979`): tracking/mapping x iter (ms) / frame (s)
    for phase, unit in (
        ("tracking_iter", "ms"), ("tracking_frame", "s"),
        ("mapping_iter", "ms"), ("mapping_frame", "s"),
    ):
        vals = state.timing[phase]
        if vals:
            mean = np.mean(vals)
            val = mean * 1000 if unit == "ms" else mean
            print(f"Average {phase.replace('_', ' ')} time: {val:.2f} {unit}")

    num_frames = config["data"].get("num_frames", -1)
    if num_frames == -1:
        num_frames = len(dataset)
    eval_dir = os.path.join(results_dir, "eval")
    results = None
    t0 = time.time()
    try:
        results = eval_sequence(
            dataset, state.params, num_frames, eval_dir,
            sil_thres=config["mapping"]["sil_thres"],
            mapping_iters=config["mapping"]["num_iters"],
            add_new_gaussians=config["mapping"]["add_new_gaussians"],
            eval_every=config.get("eval_every", 1),
            raster_cfg=RasterConfig(**config.get("raster", {})),
            device=dev,
        )
        results["eval_s"] = time.time() - t0
    except Exception as e:  # emergency checkpoint (`scripts/splatam.py:780-794`)
        print(f"[error] evaluation failed ({e}); saving emergency checkpoint")
        save_params(state.params, state.variables, results_dir,
                    name="params_emergency")

    save_params(
        state.params, state.variables, results_dir,
        intrinsics=state.intrinsics, first_w2c=state.first_w2c,
        gt_w2c_all_frames=state.gt_w2c_all,
        keyframe_time_indices=state.keyframe_time_indices,
    )
    save_ply_from_params(
        os.path.join(results_dir, "splat.ply"), state.params)
    return state, results


if __name__ == "__main__":
    main()
