"""The port's tools (``splatam_torch/tools/``), ``utils/graphics`` and
``utils/profiling`` against the JAX package's."""
import json
import os

import numpy as np
import pytest
import torch

from splatam_torch.data.base import _imread
from splatam_torch.data.datasets import NeRFCaptureDataset
from splatam_torch.tools import iphone_demo, nerfcapture2dataset, stats
from splatam_torch.utils import graphics, profiling

from tests.test_nerfcapture_live import FakeReader, _make_sample

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)


def test_graphics_match_jax():
    from splatam_tpu.utils import graphics as jg

    for focal, pixels in ((525.0, 640), (600.0, 1200), (33.3, 17)):
        assert graphics.focal2fov(focal, pixels) == jg.focal2fov(focal, pixels)
        fov = jg.focal2fov(focal, pixels)
        assert graphics.fov2focal(fov, pixels) == jg.fov2focal(fov, pixels)
    for args in ((0.01, 100.0, 1.2, 0.9), (0.1, 20.0, 0.7, 0.5)):
        np.testing.assert_array_equal(graphics.get_projection_matrix(*args),
                                      jg.get_projection_matrix(*args))


def test_phase_timers_match_jax(tmp_path, capsys):
    """The same phases give the same keys and sample counts, and the same
    report lines but the numbers; device_trace writes a trace."""
    import jax.numpy as jnp

    from splatam_tpu.utils.profiling import PhaseTimers as JTimers

    reports = []
    for timers, block in ((profiling.PhaseTimers(), {"x": [torch.ones(4)]}),
                          (JTimers(), jnp.ones(4))):
        for name, reps in (("tracking_iter", 3), ("mapping_frame", 2)):
            for _ in range(reps):
                with timers.phase(name, block_on=block):
                    pass
        out = timers.report()
        assert np.isnan(timers.mean_ms("missing"))
        reports.append((sorted(out), {k: len(v) for k, v in
                                      timers.samples.items()},
                        [line.split(":")[0] for line in
                         capsys.readouterr().out.splitlines()]))
    assert reports[0] == reports[1]
    assert reports[0][1] == {"tracking_iter": 3, "mapping_frame": 2}
    with profiling.device_trace(str(tmp_path / "trace")):
        (torch.arange(64.0) ** 2).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))


def _run_tree(root):
    """tests/test_utils_misc.py's experiment tree, with NVS and train-split
    metrics and a run without any."""
    run = root / "run_0"
    (run / "eval").mkdir(parents=True)
    np.savetxt(run / "eval" / "psnr.txt", [30.0, 32.0])
    np.savetxt(run / "eval" / "l1.txt", [0.01, 0.02])
    (run / "eval_nvs").mkdir()
    np.savetxt(run / "eval_nvs" / "nvs_psnr.txt", [25.0, np.nan, 27.0])
    np.savetxt(run / "eval_nvs" / "nvs_ssim.txt", [0.9])
    (run / "eval_train").mkdir()
    np.savetxt(run / "eval_train" / "rmse.txt", [0.1, 0.3])
    (root / "run_1" / "eval").mkdir(parents=True)
    np.savetxt(root / "run_1" / "eval" / "lpips.txt", [0.25, np.nan])
    (root / "empty_run").mkdir()


def test_stats_match_jax(tmp_path):
    from splatam_tpu.tools import stats as jstats

    _run_tree(tmp_path / "exp")
    exp = str(tmp_path / "exp")
    rows = stats.aggregate(exp)
    assert rows == jstats.aggregate(exp)
    assert stats.collect_run(os.path.join(exp, "run_0")) == \
        jstats.collect_run(os.path.join(exp, "run_0"))
    assert rows[0]["psnr"] == 31.0 and rows[0]["nvs_psnr"] == 26.0
    stats.write_csv(rows, str(tmp_path / "a.csv"))
    jstats.write_csv(rows, str(tmp_path / "b.csv"))
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()
    # the CLI
    assert stats.main([exp, "--out", str(tmp_path / "c.csv")]) == rows
    assert (tmp_path / "c.csv").read_text() == (tmp_path / "a.csv").read_text()


def _capture(module, save, n=4):
    samples = [_make_sample(i)[0] for i in range(n)]
    return module.dataset_capture_loop(FakeReader(samples, dropout_every=3),
                                       save, n, depth_scale=10.0,
                                       progress=False)


def test_nerfcapture_capture_matches_jax(tmp_path):
    """tests/test_nerfcapture_live.py's capture (4 frames with dropouts):
    the same files with the same pixels, the same transforms.json; the
    port's NeRFCaptureDataset reads the capture as the JAX package's
    does."""
    from splatam_tpu.data.datasets import NeRFCaptureDataset as JDataset
    from splatam_tpu.tools import nerfcapture2dataset as jcap

    sample, rgb, depth, pose = _make_sample(7)
    for a, b in zip(nerfcapture2dataset.decode_frame(sample),
                    jcap.decode_frame(sample)):
        np.testing.assert_array_equal(a, b)
    assert _capture(nerfcapture2dataset, str(tmp_path / "port" / "seq")) == 4
    assert _capture(jcap, str(tmp_path / "jax" / "seq")) == 4
    ours, theirs = (tmp_path / "port" / "seq", tmp_path / "jax" / "seq")
    assert json.loads((ours / "transforms.json").read_text()) == json.loads(
        (theirs / "transforms.json").read_text())
    for sub in ("rgb", "depth"):
        assert sorted(os.listdir(ours / sub)) == sorted(os.listdir(theirs / sub))
        for f in os.listdir(ours / sub):
            np.testing.assert_array_equal(_imread(str(ours / sub / f)),
                                          _imread(str(theirs / sub / f)))
    ds = NeRFCaptureDataset(str(tmp_path / "port"), "seq", desired_height=24,
                            desired_width=32)
    jds = JDataset(str(tmp_path / "port"), "seq", desired_height=24,
                   desired_width=32)
    assert len(ds) == len(jds) == 4
    for i in (0, 3):
        for a, b in zip(ds[i], jds[i]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)


def test_dds_frame_source_matches_jax():
    from splatam_tpu.tools.iphone_demo import DDSFrameSource as JSource
    from splatam_tpu.tools.iphone_demo import demo_config as jdemo

    assert iphone_demo.demo_config(3) == jdemo(3)
    samples = [_make_sample(i)[0] for i in range(3)]
    ours = iphone_demo.DDSFrameSource(FakeReader(samples, 0), 3, 12, 16)
    theirs = JSource(FakeReader(samples, 0), 3, 12, 16)
    for _ in range(3):
        for a, b in zip(ours.next_frame(), theirs.next_frame()):
            np.testing.assert_array_equal(a, b)
    assert ours.finished() and theirs.finished()


def test_iphone_demo_runs_on_capture(tmp_path):
    """run_on_capture replays 2 captured frames through the port's realtime
    SLAM on the CPU; the map grows and scores candidate poses finitely."""
    assert _capture(nerfcapture2dataset, str(tmp_path / "seq"), n=2) == 2
    state, handler = iphone_demo.run_on_capture(
        str(tmp_path), "seq", num_iters=2, height=24, width=32, device="cpu")
    assert state.counts["tracking_iters"] == 2
    assert state.params["means3D"].shape[0] > 100
    gains = handler.compute_gains(state.params, None, [
        np.array([0.0, 0.0, 0.0, 0, 0, 0, 1.0]),
        np.array([0.0, 0.0, -2.5, 0, 0, 0, 1.0])])
    assert len(gains) == 2
    assert all(np.isfinite(g["gain"]) and np.isfinite(g["sil"])
               for g in gains)
    with pytest.raises(SystemExit):  # the CLI needs a source
        iphone_demo.main(["--device", "cpu"])
