"""Config-driven transform pipeline (name -> factory registry), test side.

Counterpart of the JAX package's ``data/transform_pipeline.py``: each yaml
entry ``{transform: Name, params: {...}}`` maps to a host-side numpy
transform over a :class:`TileState`. The port has the *finalize*
transforms, the ones a test tile runs after ``set_extra_labels``
(XYZRelaFeature, XYZFeature, AddFeatsByKeys, Center, GridSampling3D,
ShiftVoxels). The train-time geometric augmentations come with the trainer;
until then :func:`build_pipeline` raises for them by name.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

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


TransformFn = Callable[[TileState, np.random.Generator], None]

_REGISTRY: Dict[str, Callable[..., TransformFn]] = {}
# the JAX package's geometric (train-time) transforms, not ported yet
_TRAIN_ONLY = ("RandomNoise", "RandomRotate", "RandomScaleAnisotropic", "RandomSymmetry",
               "ElasticDistortion", "RandomDropout", "SphereCrop", "CubeCrop", "DensityFilter")


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory

    return deco


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


@dataclass
class Pipeline:
    """The transforms of a config list, in order."""

    transforms: List[TransformFn]

    def run(self, st: TileState, rng) -> None:
        for fn in self.transforms:
            fn(st, rng)


def _entry_name(entry: dict) -> str:
    return entry.get("transform") or entry.get("name")


def build_pipeline(entries: Optional[Sequence[dict]], grid_size: float) -> Pipeline:
    """Instantiate a transform list (yaml ``{transform, params}`` dicts).

    ``grid_size`` substitutes for unresolved ``${data.first_subsampling}``
    interpolations and is the default GridSampling3D size.
    """
    fns: List[TransformFn] = []
    for entry in entries or []:
        name = _entry_name(entry)
        if name is None:
            raise ValueError(f"transform entry without a name: {entry!r}")
        if name in _TRAIN_ONLY:
            raise NotImplementedError(
                f"transform {name!r} is a train-time augmentation the PyTorch port does "
                f"not have yet (ROADMAP.md, slice 4)")
        if name not in _REGISTRY:
            raise ValueError(
                f"unknown transform {name!r}; known: {sorted(_REGISTRY)}"
            )
        params = dict(entry.get("params") or {})
        if name == "GridSampling3D":
            params.setdefault("size", grid_size)
            if isinstance(params["size"], str):  # unresolved interpolation
                params["size"] = grid_size
        fns.append(_REGISTRY[name](**params))
    return Pipeline(fns)


# the paper's test stack (the JAX package's DEFAULT_TEST_TRANSFORMS)
DEFAULT_TEST_TRANSFORMS: List[dict] = [
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
]
