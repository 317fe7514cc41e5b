"""Port binning against the JAX package's bin_gaussians_csr."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatam_torch.core.transforms import normalize
from splatam_torch.render.binning import RasterConfig, bin_gaussians_csr
from splatam_torch.render.geometry import preprocess

from tests.test_torch_geometry import NAMES, jax_scenes, torch_scene  # noqa: F401

# tiny tensor ops: torch's intra-op thread pool costs more than it
# gives here, and under parallel test workers it oversubscribes the cores
torch.set_num_threads(1)


def _both(s, depth_cap=None):
    """(JAX BinnedCSR, port Binned) for one scene."""
    from splatam_tpu.core.transforms import normalize as jnormalize
    from splatam_tpu.render.binning import RasterConfig as JCfg
    from splatam_tpu.render.binning import bin_gaussians_csr as jbin
    from splatam_tpu.render.geometry import preprocess as jpreprocess

    cfg = JCfg(max_instances=2**14, max_per_tile=1024, chunk=128,
               layout="aligned")

    @jax.jit
    def run(m, sc, q, op, cap):
        proj = jpreprocess(m, sc, jnormalize(q), s["cam"])
        return jbin(proj, s["cam"], cfg, opacities=op, depth_cap=cap)

    jb = run(s["means"], s["scales"], s["quats"], s["opac"],
             None if depth_cap is None else jnp.asarray(depth_cap))
    assert not bool(jb.overflow)
    a, cam = torch_scene(s)
    proj = preprocess(torch.tensor(a["means"]), torch.tensor(a["scales"]),
                      normalize(torch.tensor(a["quats"])), cam)
    tb = bin_gaussians_csr(
        proj, cam, RasterConfig(chunk=128, layout="aligned"),
        opacities=torch.tensor(a["opac"]),
        depth_cap=None if depth_cap is None else torch.tensor(depth_cap),
    )
    return jb, tb


def _check_equal(jb, tb):
    k = int(jb.num_instances)
    assert tb.num_instances == k
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    np.testing.assert_array_equal(tb.gid_hist.numpy(), np.asarray(jb.gid_hist))
    ends = np.cumsum(np.asarray(jb.counts))
    np.testing.assert_array_equal(tb.ranges[:, 1].numpy(), ends)
    # the streams carry the same gids in the same (tile, depth) order; the
    # scenes' depths are continuous random draws, so no depth ties occur
    np.testing.assert_array_equal(tb.sorted_gid.numpy(),
                                  np.asarray(jb.sorted_gid)[:k])


@pytest.mark.parametrize("name", NAMES)
def test_binning_matches_jax(name, jax_scenes):
    _check_equal(*_both(jax_scenes[name]))


def test_depth_cap_trim_matches_jax(jax_scenes):
    """A per-tile depth cap drops the same instances in both packages."""
    s = jax_scenes["dense_aniso"]
    _, full = _both(s)
    rng = np.random.default_rng(2)
    cap = rng.uniform(1.0, 4.0, full.counts.shape[0]).astype(np.float32)
    cap[::3] = np.inf
    jb, tb = _both(s, depth_cap=cap)
    assert tb.num_instances < full.num_instances
    _check_equal(jb, tb)
