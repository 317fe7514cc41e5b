"""Novel-view-synthesis evaluation command-line entry point.

Usage: python -m splatam_torch.run.eval_novel_view
       configs/replica_v2/eval_novel_view.py [--run_name NAME] [--device cpu]

Counterpart of ``splatam_tpu/run/eval_novel_view.py``
(`scripts/eval_novel_view.py:120-165`): loads the run's ``params.npz`` and
evaluates it on the train split (``eval/runner.eval_sequence``, saving the
rendered frames under ``eval_train``) or, where ``data.use_train_split`` is
False, on the test split (``eval/nvs.eval_nvs`` into ``eval_nvs``). Runs
on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import os

from splatam_torch.device import resolve_device
from splatam_torch.eval.nvs import eval_nvs
from splatam_torch.eval.runner import eval_sequence
from splatam_torch.render.binning import RasterConfig
from splatam_torch.run.common import (
    build_dataset,
    load_experiment_config,
    seed_everything,
    standard_argparser,
)
from splatam_torch.utils.checkpoint import load_params


def main(argv=None):
    """Run the CLI on ``argv``; returns the evaluation's results."""
    args = standard_argparser("Novel view synthesis eval").parse_args(argv)
    dev = resolve_device(args.device)
    config = load_experiment_config(args.config)
    if args.run_name is not None:
        config["run_name"] = args.run_name
    seed_everything(config.get("seed", 0))
    results_dir = os.path.join(config["workdir"], config["run_name"])

    params, _, _ = load_params(os.path.join(results_dir, "params.npz"),
                               device=dev)
    use_train_split = config["data"].get("use_train_split", True)
    dataset = build_dataset(config, use_train_split=use_train_split)
    num_frames = config["data"].get("eval_num_frames", -1)
    if num_frames == -1:
        num_frames = len(dataset)
    kwargs = dict(
        sil_thres=config["mapping"]["sil_thres"],
        mapping_iters=config["mapping"]["num_iters"],
        add_new_gaussians=config["mapping"]["add_new_gaussians"],
        eval_every=config.get("eval_every", 1),
        raster_cfg=RasterConfig(**config.get("raster", {})), device=dev,
    )
    if use_train_split:
        return eval_sequence(dataset, params, num_frames,
                             os.path.join(results_dir, "eval_train"),
                             save_frames=True, **kwargs)
    return eval_nvs(dataset, params, num_frames,
                    os.path.join(results_dir, "eval_nvs"), **kwargs)


if __name__ == "__main__":
    main()
