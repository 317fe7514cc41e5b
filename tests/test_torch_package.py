"""Package rules of the PyTorch port: no JAX, and no silent CPU fallback."""
import ast
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the JAX package and its harness (bench.py, tools/): the port keeps its own
# copies of what it needs from them
FORBIDDEN = ("jax", "jaxlib", "splatam_tpu", "bench", "tools")


def _port_sources():
    return sorted((ROOT / "splatam_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import splatam_torch.run.synthetic_slam, splatam_torch.slam.pipeline\n"
        "import splatam_torch.gs.offline, splatam_torch.gs.post_opt\n"
        "import splatam_torch.utils.checkpoint, splatam_torch.utils.ply\n"
        "import splatam_torch.eval.metrics, splatam_torch.run.common\n"
        "import splatam_torch.fisher, splatam_torch.realtime\n"
        "import splatam_torch.realtime.ros_bridge, splatam_torch.run.realtime\n"
        "import splatam_torch.utils.dump\n"
        "import splatam_torch.bench.__main__, splatam_torch.bench.profile\n"
        "import splatam_torch.bench.kernel_ablate, splatam_torch.bench.vpu_probe\n"
        "import splatam_torch.bench.ilp_probe, splatam_torch.bench.step_overhead\n"
        "import splatam_torch.bench.fwd_stages\n"
        "import splatam_torch.run.slam, splatam_torch.data\n"
        "import splatam_torch.eval.runner, splatam_torch.eval.report\n"
        "import splatam_torch.eval.lpips, splatam_torch.native\n"
        "import splatam_torch.eval.nvs, splatam_torch.utils.neighbors\n"
        "import splatam_torch.viz, splatam_torch.viz.plots\n"
        "import splatam_torch.viz.geometry, splatam_torch.viz.recon\n"
        "import splatam_torch.run.gaussian_splatting, splatam_torch.run.post_opt\n"
        "import splatam_torch.run.eval_novel_view, splatam_torch.run.export_ply\n"
        "import splatam_torch.run.viz\n"
        "import splatam_torch.parallel.mesh, splatam_torch.parallel.sharded\n"
        "import splatam_torch.parallel.pallas_sharded\n"
        "import splatam_torch.parallel.prim_sharded\n"
        "import splatam_torch.render.sh, splatam_torch.render.reference\n"
        "import splatam_torch.utils.graphics, splatam_torch.utils.profiling\n"
        "import splatam_torch.tools.stats, splatam_torch.tools.iphone_demo\n"
        "import splatam_torch.tools.nerfcapture2dataset\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: {name}"


def _entry_points():
    from splatam_torch.render.camera import setup_camera
    from splatam_torch.render.render_tiled import rasterize_tiled
    from splatam_torch.run import synthetic_slam
    from splatam_torch.gs.offline import offline_splatting
    from splatam_torch.gs.post_opt import post_splatam_opt
    from splatam_torch.slam.pipeline import rgbd_slam
    from splatam_torch.utils.checkpoint import load_params
    from splatam_torch.realtime import realtime_slam
    from splatam_torch.run import realtime
    from splatam_torch.bench import (fwd_stages, ilp_probe, kernel_ablate,
                                     step_overhead, vpu_probe)
    from splatam_torch.bench.__main__ import main as bench_main
    from splatam_torch.bench.scene import setup as bench_setup
    from splatam_torch.data.synthetic import SyntheticDataset
    from splatam_torch.eval.nvs import eval_nvs
    from splatam_torch.eval.runner import eval_sequence
    from splatam_torch.run import (eval_novel_view, export_ply,
                                   gaussian_splatting, post_opt, slam, viz)
    from splatam_torch.viz import render_trajectory
    from splatam_torch.parallel.mesh import maybe_initialize_distributed
    from splatam_torch.tools import iphone_demo

    pts = np.zeros((1, 3), np.float32)
    cam_cpu = setup_camera(16, 16, np.eye(3), np.eye(4), device="cpu")
    return {
        "rasterize_tiled": lambda: rasterize_tiled(
            pts, pts, np.ones(1, np.float32), pts, np.ones((1, 4), np.float32),
            cam_cpu,
        ),
        "rgbd_slam": lambda: rgbd_slam({}, None),
        "synthetic_slam.main": lambda: synthetic_slam.main(
            ["--frames", "1", "--width", "16", "--height", "16"]
        ),
        "setup_camera": lambda: setup_camera(16, 16, np.eye(3), np.eye(4)),
        "offline_splatting": lambda: offline_splatting({}, None),
        "post_splatam_opt": lambda: post_splatam_opt(
            {"data": {"num_frames": 1}}, None, {}),
        "load_params": lambda: load_params("params.npz"),
        "realtime_slam": lambda: realtime_slam({}, None),
        "realtime.main": lambda: realtime.main(["config.py"]),
        "bench.setup": lambda: bench_setup(n=10, w=16, h=16),
        "bench.main": lambda: bench_main(["--n", "10", "--w", "16", "--h", "16"]),
        "kernel_ablate.main": lambda: kernel_ablate.main(["--n", "10"]),
        "vpu_probe.main": lambda: vpu_probe.main(["--steps", "1"]),
        "ilp_probe.main": lambda: ilp_probe.main(["--steps", "1"]),
        "step_overhead.main": lambda: step_overhead.main(["--steps", "1"]),
        "fwd_stages.main": lambda: fwd_stages.main(["--n", "10"]),
        "slam.main": lambda: slam.main(["config.py"]),
        "rgbd_slam(dataset)": lambda: rgbd_slam(
            {"tracking": {}, "mapping": {}, "data": {}},
            SyntheticDataset(num_frames=2, width=16, height=16,
                             device="cpu")),
        "eval_sequence": lambda: eval_sequence(
            [], {}, 0, "eval", 0.5, 0, False),
        "gaussian_splatting.main": lambda: gaussian_splatting.main(["c.py"]),
        "post_opt.main": lambda: post_opt.main(["c.py"]),
        "eval_novel_view.main": lambda: eval_novel_view.main(["c.py"]),
        "export_ply.main": lambda: export_ply.main(["c.py"]),
        "viz.main": lambda: viz.main(["c.py"]),
        "eval_nvs": lambda: eval_nvs([], {}, 0, "eval", 0.5, 0, False),
        "render_trajectory": lambda: render_trajectory(
            {}, np.eye(3), np.eye(4), "recon", width=16, height=16),
        "maybe_initialize_distributed": lambda: _with_env(
            {"WORLD_SIZE": "1", "RANK": "0"}, maybe_initialize_distributed),
        "iphone_demo.run_on_capture": lambda: iphone_demo.run_on_capture(
            "capture", "seq"),
        "iphone_demo.main": lambda: iphone_demo.main(
            ["--capture_dir", "capture"]),
    }


def _with_env(env, fn):
    with mock.patch.dict(os.environ, env):
        return fn()


@pytest.mark.parametrize(
    "name", ["rasterize_tiled", "rgbd_slam", "synthetic_slam.main", "setup_camera",
             "offline_splatting", "post_splatam_opt", "load_params",
             "realtime_slam", "realtime.main", "bench.setup", "bench.main",
             "kernel_ablate.main", "vpu_probe.main", "ilp_probe.main",
             "step_overhead.main", "fwd_stages.main", "slam.main",
             "rgbd_slam(dataset)", "eval_sequence", "gaussian_splatting.main",
             "post_opt.main", "eval_novel_view.main", "export_ply.main",
             "viz.main", "eval_nvs", "render_trajectory",
             "maybe_initialize_distributed", "iphone_demo.run_on_capture",
             "iphone_demo.main"]
)
def test_entry_points_default_to_cuda(name, monkeypatch):
    """With no device given, entry points ask for CUDA and raise without it
    (here CUDA is absent, or hidden); they never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[name]()


@pytest.mark.parametrize("cli", ["slam", "gaussian_splatting", "post_opt",
                                 "realtime"])
def test_clis_call_maybe_initialize_distributed(cli, monkeypatch):
    """Each CLI calls maybe_initialize_distributed first, as the JAX CLIs
    do; with none of its variables set it starts no process group, and the
    run goes on as a single process (here: to the device check, which
    raises without CUDA)."""
    import importlib

    import torch.distributed as dist

    from splatam_torch.parallel import mesh

    module = importlib.import_module(f"splatam_torch.run.{cli}")
    calls = []
    real = mesh.maybe_initialize_distributed

    def hook(device=None):
        calls.append(device)
        return real(device)

    for key in ("WORLD_SIZE", "SPLATAM_TPU_COORDINATOR",
                "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(key, raising=False)
    # the realtime CLI imports it inside main, the others at the top
    target = module if hasattr(module, "maybe_initialize_distributed") else mesh
    monkeypatch.setattr(target, "maybe_initialize_distributed", hook)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(["config.py"])
    assert calls == [None]
    assert not dist.is_initialized()
