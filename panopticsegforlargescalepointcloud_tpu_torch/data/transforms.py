"""Host-side tile transforms (numpy, rng-driven).

A copy of the JAX package's ``data/transforms.py``: the same
``np.random.Generator`` makes the same draws in the same order, so a seed
gives the same tiles in both packages. The paper configs train with
RandomNoise, RandomRotate (z, 180 degrees), RandomScaleAnisotropic
(0.9-1.1) and RandomSymmetry (x), then the XYZRela + XYZ features, Center,
the quantizing GridSampling3D and ShiftVoxels; test tiles skip the
augmentations and ShiftVoxels. The other geometric transforms
(ElasticDistortion, RandomDropout, SphereCrop, CubeCrop, DensityFilter)
follow upstream torch-points3d's ``core/data_transform``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .voxelize import grid_sample


def random_noise(pos, rng, sigma=0.01, clip=0.05):
    noise = np.clip(sigma * rng.standard_normal(pos.shape), -clip, clip)
    return pos + noise.astype(pos.dtype)


def random_rotate_z(pos, rng, degrees=180.0):
    a = np.deg2rad(rng.uniform(-degrees, degrees))
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], pos.dtype)
    return pos @ rot.T


def random_scale_anisotropic(pos, rng, scales=(0.9, 1.1)):
    s = rng.uniform(scales[0], scales[1], size=3).astype(pos.dtype)
    return pos * s


def random_symmetry(pos, rng, axis=(True, False, False)):
    pos = pos.copy()
    for i, ax in enumerate(axis):
        if ax and rng.random() < 0.5:
            pos[:, i] = pos[:, i].max() - pos[:, i]
    return pos


def make_features(pos) -> np.ndarray:
    """FEAT=4 input features: [x_rela, y_rela, z_rela, z_abs] where *_rela =
    pos - mean(pos) (XYZRelaFeature) and z_abs is the raw z (XYZFeature)."""
    rela = pos - pos.mean(0, keepdims=True)
    return np.concatenate([rela, pos[:, 2:3]], axis=1).astype(np.float32)


def finalize_tile(
    pos: np.ndarray,
    attrs: Dict[str, np.ndarray],
    grid_size: float,
    rng: np.random.Generator,
    train: bool,
    shift_voxels: bool = True,
) -> dict:
    """features -> Center -> quantized voxelization -> (ShiftVoxels).

    Returns the tile dict consumed by collate_tiles: keys coords/feats/pos
    plus the surviving attrs.
    """
    feats = make_features(pos)
    center = pos.mean(0, keepdims=True)
    pos_c = (pos - center).astype(np.float32)
    out_pos, out = grid_sample(
        pos_c, {**attrs, "_feats": feats}, grid_size, mode="last", rng=rng
    )
    coords = np.round(out_pos / grid_size).astype(np.int32)
    if train and shift_voxels:
        coords = coords + rng.integers(0, 100, size=3).astype(np.int32)
        # keep keys in the packed-bit budget: re-center the shifted lattice
        coords = coords - (coords.min(0) + coords.max(0)) // 2
    tile = dict(out)
    tile["feats"] = tile.pop("_feats")
    tile["coords"] = coords
    tile["pos"] = out_pos
    return tile


def augment_tile(pos: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The paper's train-time geometric augmentation stack."""
    pos = random_noise(pos, rng)
    pos = random_rotate_z(pos, rng)
    pos = random_scale_anisotropic(pos, rng)
    pos = random_symmetry(pos, rng)
    return pos.astype(np.float32)


# ---------------------------------------------------------------------------
# Transforms beyond the paper configs; the subsetting ones return keep
# indices or masks, so callers subset every per-point attribute alike.


def elastic_distortion(
    pos: np.ndarray,
    rng: np.random.Generator,
    granularity=(0.2, 0.8),
    magnitude=(0.4, 1.6),
    apply_prob: float = 0.95,
) -> np.ndarray:
    """Smooth random displacement field sampled on a coarse lattice: per
    granularity g, a gaussian-noise vector lattice of cell size g is
    box-blurred (3-tap per axis, 2 rounds), trilinearly interpolated at the
    points, and added scaled by the paired magnitude."""
    from scipy import ndimage
    from scipy.interpolate import RegularGridInterpolator

    if rng.random() >= apply_prob:
        return pos
    pos = pos.astype(np.float32)
    for g, mag in zip(granularity, magnitude):
        pmin = pos.min(0)
        dim = ((pos - pmin).max(0) // g).astype(int) + 3
        noise = rng.standard_normal(size=(*dim, 3)).astype(np.float32)
        for _ in range(2):
            for ax in range(3):
                shape = [1, 1, 1, 1]
                shape[ax] = 3
                noise = ndimage.convolve(
                    noise, np.full(shape, 1 / 3, np.float32),
                    mode="constant", cval=0.0,
                )
        axes = [
            np.linspace(pmin[d] - g, pmin[d] + g * (dim[d] - 2), dim[d])
            for d in range(3)
        ]
        interp = RegularGridInterpolator(
            axes, noise, bounds_error=False, fill_value=0.0
        )
        pos = pos + interp(pos).astype(np.float32) * mag
    return pos


def random_dropout(
    n: int,
    rng: np.random.Generator,
    dropout_ratio: float = 0.2,
    apply_prob: float = 0.5,
) -> np.ndarray:
    """Keep-indices for random point dropout: a random ``(1-ratio)`` subset
    with probability ``apply_prob``, else every point."""
    if rng.random() >= apply_prob:
        return np.arange(n)
    keep = max(int(n * (1.0 - dropout_ratio)), 1)
    return rng.choice(n, size=keep, replace=False)


def sphere_crop(
    pos: np.ndarray, rng: np.random.Generator, radius: float = 50.0
) -> np.ndarray:
    """Keep-mask for a ball of ``radius`` around a random point."""
    c = pos[rng.integers(0, len(pos))]
    return np.linalg.norm(pos - c, axis=1) <= radius


def cube_crop(
    pos: np.ndarray,
    rng: np.random.Generator,
    c: float = 1.0,
    rot_degrees: Tuple[float, float, float] = (180.0, 180.0, 180.0),
) -> np.ndarray:
    """Keep-mask for a randomly rotated cube of half-size ``c`` centered on
    a random point (the cloud is rotated about the center, then the
    axis-aligned cube is kept)."""
    center = pos[rng.integers(0, len(pos))]
    rel = pos - center
    for ax, deg in enumerate(rot_degrees):
        a = np.deg2rad(rng.uniform(-deg, deg))
        cs, sn = np.cos(a), np.sin(a)
        i, j = [(1, 2), (0, 2), (0, 1)][ax]
        rot = np.eye(3, dtype=pos.dtype)
        rot[i, i] = cs
        rot[i, j] = -sn
        rot[j, i] = sn
        rot[j, j] = cs
        rel = rel @ rot.T
    return np.all(np.abs(rel) < c, axis=1)


def density_filter(
    pos: np.ndarray, radius: float = 0.16, min_density: int = 16
) -> np.ndarray:
    """Keep-mask dropping points with fewer than ``min_density`` neighbors
    (themselves included) within ``radius``."""
    from scipy.spatial import cKDTree

    tree = cKDTree(pos)
    counts = tree.query_ball_point(pos, r=radius, return_length=True)
    return np.asarray(counts) >= min_density
