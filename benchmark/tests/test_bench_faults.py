"""Runs on the CPU at a tiny size, driven as on the card (the program's
kernels' plain versions): the sound run is correct; the precision control
(the reference in bfloat16 in the program's place) and every planted fault
make ``correct`` false.

At this size (96x54 pixels, a focal length of 48; SLAM with four tracking
and four mapping iterations) the tracked motion is off by about a
centimetre per frame, so the SLAM test holds ``rpe_m`` to the sound run's
reading plus 5 cm and plants a pose fault of 10 cm (1 cm on the card);
every other number is held to the cell's limits.
"""
import time

import pytest
import torch

from benchmark.core.manifest import Cell, load_manifest

# the training cell is not in BENCHMARK.json yet (PERF.md, section 7); its
# runner runs here as it would there
TRAIN = {"name": "replica_train", "config": "replica", "traffic": "train",
         "chips": 1, "why": "3DGS training at Replica scale"}
from benchmark.runners import slam, train
from benchmark.run import judge

SEED = 2**31 + 11
RUNNERS = {"replica_slam": slam, "replica_train": train}
FAULTS = {"replica_slam": ["track_unchanged", "map_unchanged",
                           "map_half_batch", "pose_altered"],
          "replica_train": ["unchanged", "half_batch", "frame_altered"]}


def shrink(cfg, cam, traffic):
    for k in ("width", "height"):
        cam[k] = int(cam[k] * 0.08)
    for k in ("fx", "fy", "cx", "cy"):
        cam[k] *= 0.08
    if "tracking" in cfg:
        cfg["tracking"]["num_iters"] = 4
        cfg["mapping"]["num_iters"] = 4
        traffic["frames_made"] = 10
    else:
        traffic.update(frames_made=8, setup_iters=4, trace_iters=2)


def go(cell, **kw):
    return RUNNERS[cell.name].run(cell, SEED, 0.5, False, torch.device("cpu"),
                                  time.perf_counter(), lambda *a: None,
                                  shrink=shrink, **kw)


@pytest.fixture(scope="module")
def sound_runs():
    """The sound run of each cell, made once: (cell, result, limits)."""
    torch.set_num_threads(4)
    made = {}

    def get(name):
        if name not in made:
            manifest = load_manifest()
            if name not in {w["name"] for w in manifest["workloads"]}:
                manifest["workloads"].append(TRAIN)
            cell = Cell(manifest, name)
            sound = go(cell, control=True)
            limits = dict(cell.limits)
            if "rpe_m" in limits:
                limits["rpe_m"] = sound["checks"]["rpe_m"] + 0.05
            made[name] = cell, sound, limits
        return made[name]
    return get


@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_sound_run_is_correct(sound_runs, name):
    _, sound, limits = sound_runs(name)
    ok, shown = judge(sound["checks"], limits)
    assert ok, shown


@pytest.mark.parametrize("name", sorted(RUNNERS))
def test_control_is_not_correct(sound_runs, name):
    _, sound, limits = sound_runs(name)
    ok, _ = judge({**sound["checks"], **sound["control"]}, limits)
    assert not ok


@pytest.mark.parametrize("name,fault", [(n, f) for n in sorted(RUNNERS)
                                        for f in FAULTS[n]])
def test_fault_is_not_correct(sound_runs, name, fault, monkeypatch):
    cell, _, limits = sound_runs(name)
    monkeypatch.setattr(slam, "POSE_ALTERATION", 0.1)
    ok, shown = judge(go(cell, fault=fault)["checks"], limits)
    assert not ok, shown
