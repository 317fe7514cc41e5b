"""PLY export/import in the Inria 3DGS splat layout.

The port's copy of ``splatam_tpu/utils/ply.py``, in numpy; the params may
also be tensors, on any device. Parity with `scripts/export_ply.py:20-78`: vertex attributes
(x y z, nx ny nz, f_dc_0..2, opacity, scale_0..2, rot_0..3) as float32 in a
binary_little_endian PLY, DC spherical harmonics = (rgb - 0.5) / C0. The
plyfile dependency is replaced by a hand-rolled writer/reader (the format is
a fixed-stride float32 record array).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

C0 = 0.28209479177387814  # Y_0^0 spherical harmonic constant

_ATTRS = (
    "x", "y", "z",
    "nx", "ny", "nz",
    "f_dc_0", "f_dc_1", "f_dc_2",
    "opacity",
    "scale_0", "scale_1", "scale_2",
    "rot_0", "rot_1", "rot_2", "rot_3",
)


def rgb_to_spherical_harmonic(rgb: np.ndarray) -> np.ndarray:
    return (rgb - 0.5) / C0


def spherical_harmonic_to_rgb(sh: np.ndarray) -> np.ndarray:
    return sh * C0 + 0.5


def save_ply(
    path: str,
    means: np.ndarray,  # (N, 3)
    scales: np.ndarray,  # (N, 1|3) log scales
    rotations: np.ndarray,  # (N, 4) wxyz
    rgbs: np.ndarray,  # (N, 3)
    opacities: np.ndarray,  # (N, 1) logits
    normals: np.ndarray | None = None,
) -> None:
    n = means.shape[0]
    if normals is None:
        normals = np.zeros_like(means)
    if scales.shape[1] == 1:
        scales = np.tile(scales, (1, 3))
    colors = rgb_to_spherical_harmonic(rgbs)

    data = np.concatenate(
        (means, normals, colors, opacities, scales, rotations), axis=1
    ).astype("<f4")
    assert data.shape[1] == len(_ATTRS)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {a}" for a in _ATTRS]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(data.tobytes())
    print(f"Saved PLY format Splat to {path}")


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def save_ply_from_params(path: str, params: Dict[str, np.ndarray]) -> None:
    """Export a params dict / loaded params.npz (`export_ply.py:56-78`)."""
    save_ply(
        path,
        _numpy(params["means3D"]),
        _numpy(params["log_scales"]),
        _numpy(params["unnorm_rotations"]),
        _numpy(params["rgb_colors"]),
        _numpy(params["logit_opacities"]),
    )


def load_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a splat PLY back into a params-style dict (round trip of
    save_ply; also accepts standard Inria 3DGS exports with extra SH rest
    coefficients, which are ignored)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        body = f.read()

    n = None
    props = []
    fmt_binary = any("binary_little_endian" in l for l in header)
    if not fmt_binary:
        raise ValueError("Only binary_little_endian PLY supported")
    for line in header:
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
        elif line.startswith("property float"):
            props.append(line.split()[-1])
    assert n is not None
    data = np.frombuffer(body, "<f4", count=n * len(props)).reshape(n, len(props))
    col = {p: data[:, i] for i, p in enumerate(props)}

    rgb = spherical_harmonic_to_rgb(
        np.stack([col["f_dc_0"], col["f_dc_1"], col["f_dc_2"]], axis=-1)
    )
    return {
        "means3D": np.stack([col["x"], col["y"], col["z"]], axis=-1),
        "rgb_colors": rgb,
        "log_scales": np.stack(
            [col["scale_0"], col["scale_1"], col["scale_2"]], axis=-1
        ),
        "unnorm_rotations": np.stack(
            [col["rot_0"], col["rot_1"], col["rot_2"], col["rot_3"]], axis=-1
        ),
        "logit_opacities": col["opacity"][:, None],
    }
