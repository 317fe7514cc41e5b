"""The device frame generator repeats for a seed (here on the CPU)."""
import json

import numpy as np
import torch

from benchmark.core.manifest import BENCH
from benchmark.core.scene import Sequence

with open(BENCH / "traffic" / "slam.json") as f:
    TRAFFIC = json.load(f)
CAM = {"width": 64, "height": 40, "fx": 32.0, "fy": 32.0, "cx": 31.5, "cy": 19.5}


def make(seed, frames=5):
    return Sequence(TRAFFIC["scene"], TRAFFIC["motion"], CAM, frames, seed, "cpu")


def test_same_seed_same_frames():
    a, b = make(2**31 + 7), make(2**31 + 7)
    assert torch.equal(a.color, b.color) and torch.equal(a.depth, b.depth)
    assert np.array_equal(a.poses, b.poses)
    for x, y in zip(a[3], b[3]):
        assert np.array_equal(x, y)


def test_seeds_change_content_not_sizes():
    a, b = make(1), make(2)
    assert a.color.shape == b.color.shape == (5, 40, 64, 3)
    assert not torch.equal(a.color, b.color)
    assert np.array_equal(a.poses, b.poses)  # one path for every seed
    # full valid depth, between the panel and the wall
    for s in (a, b):
        assert bool((s.depth > 1.5).all()) and bool((s.depth < 3.5).all())
        assert np.allclose(s.poses[0], np.eye(4))
        step = np.linalg.norm(np.diff(s.poses[:, :3, 3], axis=0), axis=1)
        assert step.max() < 0.03


def test_loader_contract_and_frame():
    s = make(5)
    color, depth, k4, c2w = s[2]
    assert color.shape == (40, 64, 3) and depth.shape == (40, 64, 1)
    assert color.dtype == np.float32 and 0 <= color.min() and color.max() <= 255
    im, d = s.frame(2)
    assert np.array_equal(im.numpy(), (np.transpose(color, (2, 0, 1)) / 255.0).astype(np.float32))
    assert np.array_equal(d.numpy()[0], depth[..., 0])
    try:
        s[len(s)]
    except IndexError:
        pass
    else:
        raise AssertionError("reading past the frames made must fail")
