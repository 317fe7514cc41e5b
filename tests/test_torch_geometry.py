"""Port geometry (preprocess) against the JAX package on the golden scenes."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from splatam_torch.core.transforms import matrix_to_quaternion, normalize, quat_mult
from splatam_torch.render.camera import setup_camera
from splatam_torch.render.geometry import preprocess

NAMES = ["sparse_iso", "dense_aniso", "overlap_deep"]


@pytest.fixture(scope="module")
def jax_scenes():
    from make_goldens import scenes

    return scenes()


def torch_scene(s):
    """The same scene for the port: numpy copies and a CPU camera."""
    w, h = s["cam"].image_width, s["cam"].image_height
    k = [[w * 0.9, 0, w / 2], [0, w * 0.9, h / 2], [0, 0, 1]]
    arrays = {key: np.asarray(s[key]) for key in
              ("means", "colors", "opac", "scales", "quats")}
    return arrays, setup_camera(w, h, k, np.eye(4), device="cpu")


def _weights(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 2)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


@pytest.mark.parametrize("name", NAMES)
def test_preprocess_matches_jax(name, jax_scenes):
    """Outputs equal to float noise, radius and tiles_touched exactly, and
    the gradients of a random linear functional of means2d / conic / depth
    through preprocess at 1e-5 of their scale."""
    from splatam_tpu.core.transforms import normalize as jnormalize
    from splatam_tpu.render.geometry import preprocess as jpreprocess

    s = jax_scenes[name]
    a, cam = torch_scene(s)
    wm, wc, wd = _weights(a["means"].shape[0], 1)

    def jfun(m, sc, q):
        p = jpreprocess(m, sc, jnormalize(q), s["cam"])
        return (jnp.sum(p.means2d * wm) + jnp.sum(p.conic * wc)
                + jnp.sum(p.depths * wd)), p

    (_, jp), jg = jax.jit(
        jax.value_and_grad(jfun, argnums=(0, 1, 2), has_aux=True)
    )(s["means"], s["scales"], s["quats"])
    ts = [torch.tensor(a[k], requires_grad=True)
          for k in ("means", "scales", "quats")]
    tp = preprocess(ts[0], ts[1], normalize(ts[2]), cam)
    loss = ((tp.means2d * torch.tensor(wm)).sum()
            + (tp.conic * torch.tensor(wc)).sum()
            + (tp.depths * torch.tensor(wd)).sum())
    loss.backward()

    for field in ("radius", "tiles_touched", "rect_min", "rect_max"):
        np.testing.assert_array_equal(
            getattr(tp, field).numpy(), np.asarray(getattr(jp, field)),
            err_msg=field,
        )
    for field in ("means2d", "depths", "conic"):
        ref = np.asarray(getattr(jp, field))
        np.testing.assert_allclose(getattr(tp, field).detach().numpy(), ref,
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    # one scale for all three: isotropic scenes have quaternion gradients
    # that are zero up to rounding noise
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jg)
    for t, g, field in zip(ts, jg, ("means", "scales", "quats")):
        np.testing.assert_allclose(t.grad.numpy() / scale,
                                   np.asarray(g) / scale, atol=1e-5,
                                   err_msg=field)


def test_transforms_match_jax():
    from splatam_tpu.core import transforms as jt

    rng = np.random.default_rng(4)
    q1 = rng.normal(size=(16, 4)).astype(np.float32)
    q2 = rng.normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_allclose(
        quat_mult(normalize(torch.tensor(q1)), torch.tensor(q2)).numpy(),
        np.asarray(jt.quat_mult(jt.normalize(jnp.asarray(q1)), jnp.asarray(q2))),
        rtol=1e-5, atol=1e-6,
    )
    rot = np.asarray(jt.quat_to_rotmat(jt.normalize(jnp.asarray(q1))))
    np.testing.assert_allclose(
        matrix_to_quaternion(torch.tensor(rot)).numpy(),
        np.asarray(jt.matrix_to_quaternion(jnp.asarray(rot))),
        rtol=1e-5, atol=1e-6,
    )


def test_mark_visible_matches_jax():
    from splatam_tpu.render.camera import setup_camera as jsetup
    from splatam_tpu.render.geometry import mark_visible as jmark

    from splatam_torch.render.geometry import mark_visible

    rng = np.random.default_rng(5)
    pts = rng.uniform(-2, 2, (64, 3)).astype(np.float32)  # half behind
    k = [[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]]
    w2c = np.eye(4)
    w2c[:3, 3] = [0.1, -0.2, 0.3]
    got = mark_visible(torch.tensor(pts), setup_camera(64, 48, k, w2c, device="cpu"))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jmark(pts, jsetup(64, 48, k, w2c))))
