"""The trace reduction and the metric readers on a recorded trace."""
import pytest

from benchmark.core import readers, work
from benchmark.core.manifest import reader
from benchmark.core.trace import (WINDOW, Event, busy_seconds, kernel_seconds,
                                  summarize, top_ops)

MS = 1_000_000  # ns


def recorded():
    """A traced window of 10 ms on one host thread (tid 7): two harness
    spans over host ops, and device work with an overlap and two gaps."""
    return [
        Event(WINDOW, False, 0, 10 * MS, 7),
        Event("bm.track_frame", False, 0, 6 * MS, 7),
        Event("aten::add", False, 0, 2 * MS, 7),
        Event("cudaLaunchKernel", False, 1 * MS, MS // 2, 7),
        Event("aten::mul", False, 3 * MS, 3 * MS, 7),
        Event("bm.map_step", False, 6 * MS, 4 * MS, 7),
        Event("aten::sum", False, 6 * MS, 4 * MS, 7),
        Event("other thread", False, 0, 10 * MS, 8),
        # device: [1, 3) and [2, 4) overlap -> busy [1, 4); [7, 9)
        Event("raster_fwd_kernel<false>(float const*)", True, 1 * MS, 2 * MS, 0),
        Event("elementwise", True, 2 * MS, 2 * MS, 0),
        Event("raster_bwd_kernel(float const*)", True, 7 * MS, 2 * MS, 0),
        Event("outside", True, 20 * MS, MS, 0),
    ]


def test_summary():
    s = summarize(recorded())
    assert s.window_s == pytest.approx(0.010)
    assert s.busy_s == pytest.approx(0.005)  # the overlap counted once
    assert s.device_ops == 3
    gaps = dict(s.idle_gaps)
    assert gaps["bm.track_frame / aten::add"] == pytest.approx(0.001)
    assert gaps["bm.track_frame / aten::mul"] == pytest.approx(0.003)
    assert gaps["bm.map_step / aten::sum"] == pytest.approx(0.001)
    assert sum(gaps.values()) == pytest.approx(0.005)
    assert top_ops(s)[0][1] == pytest.approx(0.002)
    assert kernel_seconds(s, ["raster_fwd_kernel", "raster_bwd_kernel"]) == pytest.approx(0.004)


def test_busy_seconds():
    """The device meter's reduction: overlapping intervals counted once."""
    assert busy_seconds([(3 * MS, 4 * MS), (1 * MS, 3 * MS), (2 * MS, 3 * MS),
                         (7 * MS, 9 * MS)]) == pytest.approx(0.005)
    assert busy_seconds([]) == 0


def test_readers():
    s = summarize(recorded())
    ctx = {"family": "slam", "trace": s,
           "work": {"ops": 1e9, "raster_least_s": 0.001, "iterations": 2},
           "tracking_iter": [0.02, 0.03], "mapping_iter": [0.04],
           "window": {"frames": 4, "seconds": 8.4}}
    assert reader("device_idle.slam")(ctx) == pytest.approx(50.0)
    assert reader("device_ops_per_iter.slam")(ctx) == pytest.approx(1.5)
    assert reader("raster_roofline.slam")(ctx) == pytest.approx(25.0)
    assert reader("slam_mfu")(ctx) == pytest.approx(100 * 1e9 / (0.01 * work.F32_PEAK_FLOPS))
    assert reader("tracking_ms_per_iter")(ctx) == pytest.approx(25.0)
    assert reader("mapping_ms_per_iter")(ctx) == pytest.approx(40.0)
    assert reader("slam_wall_s_per_frame")(ctx) == pytest.approx(2.1)
    # a reader that finds nothing to read returns nothing
    assert reader("device_idle.slam")({"family": "train"}) is None
    assert readers.roofline_pct({**ctx, "trace": summarize(recorded()[:8])}, "slam", "raster") is None
    assert reader("tracking_ms_per_iter")({}) is None
    assert reader("slam_wall_s_per_frame")({"family": "train"}) is None


def test_render_cost():
    ops, least = work.render_cost(1000, 100, 32, 16, backward=False)
    assert ops == 1000 * 256 * (22 + 2 * 6)
    ops_b, least_b = work.render_cost(1000, 100, 32, 16, backward=True)
    assert ops_b == ops + 1000 * 256 * (56 + 4 * 4) and least_b > least


def test_device_s_per_frame_lost_session():
    """A frame whose profiler session lost records takes its neighbours'
    mean; whole frames count as read."""
    from benchmark.runners.slam import device_s_per_frame

    whole = [(1.0, 1000), (1.2, 1010), (1.4, 990)]
    assert device_s_per_frame(whole, 3, lambda *a: None) == pytest.approx(1.2)
    lost = [(1.0, 1000), (0.5, 400), (1.4, 990)]
    assert device_s_per_frame(lost, 3, lambda *a: None) == pytest.approx(1.2)
    first = [(0.1, 100), (1.2, 1010), (1.4, 990)]
    assert device_s_per_frame(first, 3, lambda *a: None) == pytest.approx(3.8 / 3)
    with pytest.raises(RuntimeError):
        device_s_per_frame(whole, 4, lambda *a: None)
