"""Config-driven transform pipeline (name -> factory registry).

Counterpart of the JAX package's ``data/transform_pipeline.py``: each yaml
entry ``{transform: Name, params: {...}}`` maps to a host-side numpy
transform over a :class:`TileState`. A pipeline runs in two phases around
``set_extra_labels``, which needs the *augmented* positions for its
bbox-centre vote offsets:

* **geometric** transforms move positions and may subset points
  (RandomNoise/Rotate/Scale/Symmetry, ElasticDistortion, RandomDropout,
  Sphere/CubeCrop, DensityFilter); a subset applies to every per-point
  array;
* **finalize** transforms build features and voxelize (XYZRelaFeature,
  XYZFeature, AddFeatsByKeys, Center, GridSampling3D, ShiftVoxels).

``DEFAULT_TRAIN_TRANSFORMS`` and ``DEFAULT_TEST_TRANSFORMS`` are the paper
stacks, used where the data yaml carries no list.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from . import transforms as T
from .voxelize import grid_sample


@dataclass
class TileState:
    """Mutable per-tile state threaded through the pipeline."""

    pos: np.ndarray
    attrs: Dict[str, np.ndarray]  # per-point arrays, subset with pos
    named_feats: Dict[str, np.ndarray] = field(default_factory=dict)
    feats: Optional[np.ndarray] = None
    coords: Optional[np.ndarray] = None
    train: bool = True

    def subset(self, keep) -> None:
        self.pos = self.pos[keep]
        self.attrs = {k: v[keep] for k, v in self.attrs.items()}
        self.named_feats = {k: v[keep] for k, v in self.named_feats.items()}
        if self.feats is not None:
            self.feats = self.feats[keep]


TransformFn = Callable[[TileState, np.random.Generator], None]

_REGISTRY: Dict[str, Callable[..., TransformFn]] = {}
# names whose transforms run before set_extra_labels (position/subset ops)
GEOMETRIC = set()


def register(name: str, geometric: bool = False):
    def deco(factory):
        _REGISTRY[name] = factory
        if geometric:
            GEOMETRIC.add(name)
        return factory

    return deco


# --------------------------- geometric phase ---------------------------


@register("RandomNoise", geometric=True)
def _noise(sigma: float = 0.01, clip: float = 0.05) -> TransformFn:
    def fn(st, rng):
        st.pos = T.random_noise(st.pos, rng, sigma=sigma, clip=clip)

    return fn


@register("RandomRotate", geometric=True)
def _rotate(degrees: float = 180.0, axis: int = 2) -> TransformFn:
    """Rotation about one axis by a uniform angle in [-degrees, degrees]."""

    def fn(st, rng):
        a = np.deg2rad(rng.uniform(-degrees, degrees))
        c, s = np.cos(a), np.sin(a)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        rot = np.eye(3, dtype=st.pos.dtype)
        rot[i, i] = c
        rot[i, j] = -s
        rot[j, i] = s
        rot[j, j] = c
        st.pos = st.pos @ rot.T

    return fn


@register("RandomScaleAnisotropic", geometric=True)
def _scale(scales: Sequence[float] = (0.9, 1.1)) -> TransformFn:
    def fn(st, rng):
        st.pos = T.random_scale_anisotropic(st.pos, rng, scales=tuple(scales))

    return fn


@register("RandomSymmetry", geometric=True)
def _symmetry(axis: Sequence[bool] = (True, False, False)) -> TransformFn:
    def fn(st, rng):
        st.pos = T.random_symmetry(st.pos, rng, axis=tuple(axis))

    return fn


@register("ElasticDistortion", geometric=True)
def _elastic(
    granularity: Sequence[float] = (0.2, 0.8),
    magnitude: Sequence[float] = (0.4, 1.6),
    apply_distorsion: bool = True,
    apply_prob: float = 0.95,
) -> TransformFn:
    def fn(st, rng):
        if not apply_distorsion:
            return
        st.pos = T.elastic_distortion(
            st.pos, rng, granularity=tuple(granularity),
            magnitude=tuple(magnitude), apply_prob=apply_prob,
        )

    return fn


@register("RandomDropout", geometric=True)
def _dropout(
    dropout_ratio: float = 0.2, dropout_application_ratio: float = 0.5
) -> TransformFn:
    def fn(st, rng):
        keep = T.random_dropout(
            len(st.pos), rng, dropout_ratio=dropout_ratio,
            apply_prob=dropout_application_ratio,
        )
        if len(keep) != len(st.pos):
            st.subset(keep)

    return fn


@register("SphereCrop", geometric=True)
def _sphere_crop(radius: float = 50.0) -> TransformFn:
    def fn(st, rng):
        st.subset(T.sphere_crop(st.pos, rng, radius=radius))

    return fn


@register("CubeCrop", geometric=True)
def _cube_crop(
    c: float = 1.0, rot_x: float = 180.0, rot_y: float = 180.0,
    rot_z: float = 180.0,
) -> TransformFn:
    def fn(st, rng):
        st.subset(T.cube_crop(st.pos, rng, c=c,
                              rot_degrees=(rot_x, rot_y, rot_z)))

    return fn


@register("DensityFilter", geometric=True)
def _density(radius_nn: float = 0.16, min_num: int = 16) -> TransformFn:
    def fn(st, rng):
        st.subset(T.density_filter(st.pos, radius=radius_nn,
                                   min_density=min_num))

    return fn


# --------------------------- finalize phase ---------------------------


@register("XYZRelaFeature")
def _xyz_rela(add_x: bool = True, add_y: bool = True,
              add_z: bool = True) -> TransformFn:
    def fn(st, rng):
        rela = st.pos - st.pos.mean(0, keepdims=True)
        for i, (name, add) in enumerate(
            zip(("pos_x_rela", "pos_y_rela", "pos_z_rela"),
                (add_x, add_y, add_z))
        ):
            if add:
                st.named_feats[name] = rela[:, i].astype(np.float32)

    return fn


@register("XYZFeature")
def _xyz(add_x: bool = False, add_y: bool = False,
         add_z: bool = True) -> TransformFn:
    def fn(st, rng):
        for i, (name, add) in enumerate(
            zip(("pos_x", "pos_y", "pos_z"), (add_x, add_y, add_z))
        ):
            if add:
                st.named_feats[name] = st.pos[:, i].astype(np.float32)

    return fn


@register("AddFeatsByKeys")
def _add_feats(
    feat_names: Sequence[str] = (),
    list_add_to_x: Sequence[bool] = (),
    delete_feats: Sequence[bool] = (),
) -> TransformFn:
    def fn(st, rng):
        cols = []
        if st.feats is not None:
            cols.append(st.feats)
        for k, (name, add) in enumerate(zip(feat_names, list_add_to_x)):
            if add:
                cols.append(st.named_feats[name][:, None])
            if k < len(delete_feats) and delete_feats[k]:
                st.named_feats.pop(name, None)
        st.feats = (np.concatenate(cols, axis=1).astype(np.float32)
                    if cols else None)

    return fn


@register("Center")
def _center() -> TransformFn:
    def fn(st, rng):
        st.pos = (st.pos - st.pos.mean(0, keepdims=True)).astype(np.float32)

    return fn


@register("GridSampling3D")
def _grid_sampling(size: float = 0.2, quantize_coords: bool = False,
                   mode: str = "last") -> TransformFn:
    def fn(st, rng):
        attrs = dict(st.attrs)
        if st.feats is not None:
            attrs["_feats"] = st.feats
        out_pos, out = grid_sample(st.pos, attrs, size, mode=mode, rng=rng)
        st.pos = out_pos
        st.feats = out.pop("_feats", None)
        st.attrs = out
        st.named_feats = {}
        if quantize_coords:
            st.coords = np.round(out_pos / size).astype(np.int32)

    return fn


@register("ShiftVoxels")
def _shift_voxels(apply_shift: bool = True) -> TransformFn:
    def fn(st, rng):
        if not apply_shift or st.coords is None or not st.train:
            return
        coords = st.coords + rng.integers(0, 100, size=3).astype(np.int32)
        # keep keys in the packed-bit budget: re-center the shifted lattice
        st.coords = coords - (coords.min(0) + coords.max(0)) // 2

    return fn


# --------------------------- pipeline assembly ---------------------------


@dataclass
class Pipeline:
    """Geometric + finalize transform lists built from a config list."""

    geometric: List[TransformFn]
    finalize: List[TransformFn]

    def run_geometric(self, st: TileState, rng) -> None:
        for fn in self.geometric:
            fn(st, rng)

    def run_finalize(self, st: TileState, rng) -> None:
        for fn in self.finalize:
            fn(st, rng)


def _entry_name(entry: dict) -> str:
    return entry.get("transform") or entry.get("name")


def build_pipeline(entries: Optional[Sequence[dict]], grid_size: float) -> Pipeline:
    """Instantiate a transform list (yaml ``{transform, params}`` dicts).

    ``grid_size`` substitutes for unresolved ``${data.first_subsampling}``
    interpolations and is the default GridSampling3D size.
    """
    geo: List[TransformFn] = []
    fin: List[TransformFn] = []
    for entry in entries or []:
        name = _entry_name(entry)
        if name is None:
            raise ValueError(f"transform entry without a name: {entry!r}")
        if name not in _REGISTRY:
            raise ValueError(
                f"unknown transform {name!r}; known: {sorted(_REGISTRY)}"
            )
        params = dict(entry.get("params") or {})
        if name == "GridSampling3D":
            params.setdefault("size", grid_size)
            if isinstance(params["size"], str):  # unresolved interpolation
                params["size"] = grid_size
        fn = _REGISTRY[name](**params)
        (geo if name in GEOMETRIC else fin).append(fn)
    return Pipeline(geo, fin)


DEFAULT_TRAIN_TRANSFORMS: List[dict] = [
    {"transform": "RandomNoise", "params": {"sigma": 0.01}},
    {"transform": "RandomRotate", "params": {"degrees": 180, "axis": 2}},
    {"transform": "RandomScaleAnisotropic", "params": {"scales": [0.9, 1.1]}},
    {"transform": "RandomSymmetry",
     "params": {"axis": [True, False, False]}},
    {"transform": "XYZRelaFeature",
     "params": {"add_x": True, "add_y": True, "add_z": True}},
    {"transform": "XYZFeature",
     "params": {"add_x": False, "add_y": False, "add_z": True}},
    {"transform": "AddFeatsByKeys",
     "params": {"list_add_to_x": [True, True, True, True],
                "feat_names": ["pos_x_rela", "pos_y_rela", "pos_z_rela", "pos_z"],
                "delete_feats": [True, True, True, True]}},
    {"transform": "Center"},
    {"transform": "GridSampling3D",
     "params": {"quantize_coords": True, "mode": "last"}},
    {"transform": "ShiftVoxels"},
]

DEFAULT_TEST_TRANSFORMS: List[dict] = [
    e for e in DEFAULT_TRAIN_TRANSFORMS
    if _entry_name(e) not in GEOMETRIC and _entry_name(e) != "ShiftVoxels"
]
