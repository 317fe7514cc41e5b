"""Shared driver plumbing: experiment configs, seeding, results directory.

Counterpart of ``splatam_tpu/run/common.py`` (`scripts/splatam.py:1039-1061`):
experiment configs are executable Python modules exposing a ``config``
dict, loaded by path (the files under ``configs/`` load as they are) and
copied into the results directory; ``build_dataset`` reads
``config["data"]`` with the port's loaders (``splatam_torch/data``).
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import random
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch

from splatam_torch.data import get_dataset, load_dataset_config
from splatam_torch.eval.runner import eval_sequence
from splatam_torch.render.binning import RasterConfig
from splatam_torch.utils.checkpoint import save_params
from splatam_torch.utils.ply import save_ply_from_params


def seed_everything(seed: int = 42) -> None:
    """Seed Python, numpy and torch (`utils/common_utils.py:8-22`)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    print(f"Seed: {seed}")


def load_experiment_config(path: str) -> Dict:
    """The ``config`` dict of the experiment file at ``path``."""
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.config


def prepare_results_dir(config: Dict, config_path: str) -> str:
    """``workdir/run_name``, created, with a copy of the config file."""
    results_dir = os.path.join(config["workdir"], config["run_name"])
    os.makedirs(results_dir, exist_ok=True)
    try:
        shutil.copy(config_path, os.path.join(results_dir, "config.py"))
    except shutil.SameFileError:
        pass
    return results_dir


def build_dataset(
    config: Dict,
    desired_height: Optional[int] = None,
    desired_width: Optional[int] = None,
    use_train_split: Optional[bool] = None,
):
    """The dataset ``config["data"]`` describes, at its desired size or at
    ``desired_height`` x ``desired_width``."""
    d = config["data"]
    cfg_path = d.get("gradslam_data_cfg")
    if cfg_path:
        data_cfg = load_dataset_config(cfg_path)
    else:
        # ScanNet++/NeRFCapture read intrinsics from their own metadata
        data_cfg = {"dataset_name": d.get("dataset_name", "scannetpp")}
    kwargs = dict(
        start=d.get("start", 0),
        end=d.get("end", -1),
        stride=d.get("stride", 1),
        desired_height=desired_height or d["desired_image_height"],
        desired_width=desired_width or d["desired_image_width"],
    )
    if "ignore_bad" in d:
        kwargs["ignore_bad"] = d["ignore_bad"]
    if use_train_split is not None:
        kwargs["use_train_split"] = use_train_split
    elif "use_train_split" in d:
        kwargs["use_train_split"] = d["use_train_split"]
    return get_dataset(
        data_cfg, d["basedir"], os.path.basename(d["sequence"]), **kwargs
    )


def build_datasets_with_resolutions(config: Dict):
    """The main dataset and, where the config asks for another size, the
    tracking and densification datasets (None otherwise;
    `scripts/splatam.py:504-607`)."""
    d = config["data"]
    dataset = build_dataset(config)
    tracking_dataset = None
    densify_dataset = None
    th, tw = d.get("tracking_image_height"), d.get("tracking_image_width")
    if th and (th != d["desired_image_height"] or tw != d["desired_image_width"]):
        tracking_dataset = build_dataset(config, th, tw)
    dh, dw = d.get("densification_image_height"), d.get("densification_image_width")
    if dh and (dh != d["desired_image_height"] or dw != d["desired_image_width"]):
        densify_dataset = build_dataset(config, dh, dw)
    return dataset, tracking_dataset, densify_dataset


def standard_argparser(description: str) -> argparse.ArgumentParser:
    """The CLIs' shared flags: the experiment config, ``--run_name`` and
    ``--device`` (cuda unless ``cpu`` is asked for)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("config", type=str, help="Path to experiment config (.py)")
    p.add_argument("--run_name", type=str, default=None,
                   help="Override the experiment's run name")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p


def evaluate_and_save(config: Dict, dataset, state, results_dir: str,
                      device) -> Dict[str, float]:
    """The offline-training CLIs' last steps (`scripts/
    gaussian_splatting.py`, `post_splatam_opt.py`): evaluate ``state``'s map
    on ``dataset`` into ``results_dir/eval``, then save ``params.npz`` and
    ``splat.ply`` there. Returns the evaluation's results, with ``eval_s``,
    its wall time."""
    num_frames = config["data"].get("num_frames", -1)
    if num_frames == -1:
        num_frames = len(dataset)
    t0 = time.time()
    results = eval_sequence(
        dataset, state.params, num_frames, os.path.join(results_dir, "eval"),
        sil_thres=config["train"]["sil_thres"],
        mapping_iters=config["train"]["num_iters_mapping"],
        add_new_gaussians=True, eval_every=config.get("eval_every", 1),
        raster_cfg=RasterConfig(**config.get("raster", {})), device=device,
    )
    results["eval_s"] = time.time() - t0
    save_params(
        state.params, state.variables, results_dir,
        intrinsics=state.intrinsics, first_w2c=state.first_w2c,
        gt_w2c_all_frames=state.gt_w2c_all,
    )
    save_ply_from_params(os.path.join(results_dir, "splat.ply"), state.params)
    return results
