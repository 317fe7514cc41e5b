"""Realtime (ROS-connected) SplaTAM CLI.

Counterpart of ``splatam_tpu/run/realtime.py``, with the flags of the
reference's realtime entry point (`scripts/splatam_realtime.py:1117-1162`):
gain scales (k_sil/k_eig/k_sum), sigmoid nonlinearities (nl_sil/nl_eig),
Monte-Carlo Hessian subsampling (disable_monte/n_monte), the mapping
iteration override and the realtime outlier-depth parametrization
(median_thr/median_scale), merged into the experiment config; plus
``--device``. The frame source is a replay of a dumped stream with
``--replay <dir>`` (utils/dump.py), else the ROS bridge, which needs rospy.

Usage: python -m splatam_torch.run.realtime <config.py> [--replay DIR]
       [--device cpu] [--k_sil 1000] [--k_eig 0.1] ...
"""
from __future__ import annotations

import sys


def build_argparser():
    from splatam_torch.run.common import standard_argparser

    p = standard_argparser("Run SplaTAM on a live ROS / replayed stream")
    p.add_argument("--k_sil", type=float, default=1000.0,
                   help="Scaling factor for silhouette gain")
    p.add_argument("--k_eig", type=float, default=0.1,
                   help="Scaling factor for fisher gain")
    p.add_argument("--k_sum", type=float, default=1.0,
                   help="Scaling factor for combined gain")
    p.add_argument("--nl_sil", action="store_true",
                   help="Non-linear activation for silhouette gain")
    p.add_argument("--nl_eig", action="store_true",
                   help="Non-linear activation for fisher gain")
    p.add_argument("--disable_monte", action="store_true",
                   help="Disable Monte Carlo approximation")
    p.add_argument("--n_monte", type=int, default=40,
                   help="Monte Carlo visited-pose subsample size")
    p.add_argument("--map_iter", type=int, default=None,
                   help="Override the experiment's mapping iterations")
    p.add_argument("--median_thr", type=float, default=None,
                   help="Median-based threshold for gaussian generation")
    p.add_argument("--median_scale", type=float, default=50.0,
                   help="Scaling factor for the median-based threshold")
    p.add_argument("--replay", type=str, default=None,
                   help="Replay a dumped frame stream instead of ROS")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from splatam_torch.device import resolve_device
    from splatam_torch.realtime.handler import GainConfig
    from splatam_torch.run.common import (
        load_experiment_config,
        prepare_results_dir,
        seed_everything,
    )

    dev = resolve_device(args.device)
    config = load_experiment_config(args.config)
    if args.run_name is not None:
        config["run_name"] = args.run_name
    if args.map_iter is not None:
        config["mapping"]["num_iters"] = args.map_iter
    config["mapping"]["median_thr"] = args.median_thr
    config["mapping"]["median_scale"] = args.median_scale

    gain_cfg = GainConfig(
        k_sil=args.k_sil,
        k_eig=args.k_eig,
        k_sum=args.k_sum,
        nl_sil=args.nl_sil,
        nl_eig=args.nl_eig,
        monte_carlo=None if args.disable_monte else args.n_monte,
    )

    from splatam_torch.realtime.driver import ReplaySource, realtime_slam

    if args.replay is not None:
        from splatam_torch.utils.dump import DumpedDataset

        source = ReplaySource(DumpedDataset(args.replay))
    else:
        import numpy as np

        from splatam_torch.realtime.ros_bridge import HAS_ROS, RosFrameSource

        if not HAS_ROS:
            raise SystemExit(
                "no frame source: rospy is not importable, so the live ROS "
                "stream is unavailable; pass --replay <dir> to replay a "
                "dumped stream (splatam_torch.utils.dump.dump_dataset)"
            )
        k = config["data"].get("intrinsics")
        if k is None:
            cam = config.get("camera", {})
            k = [
                [cam.get("fx", 600.0), 0, cam.get("cx", 320.0)],
                [0, cam.get("fy", 600.0), cam.get("cy", 240.0)],
                [0, 0, 1],
            ]
        source = RosFrameSource(np.asarray(k, dtype=np.float64))

    prepare_results_dir(config, args.config)
    seed_everything(config.get("seed", 0))
    state, handler = realtime_slam(config, source, gain_cfg=gain_cfg,
                                   device=dev)
    print(
        f"realtime run finished: {len(state.keyframe_time_indices)} keyframes"
    )
    return state, handler


if __name__ == "__main__":
    main()
    sys.exit(0)
