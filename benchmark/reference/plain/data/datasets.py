"""Dataset families: FOR-instance forests ("treeins") and NPM3D urban scans.

Counterpart of the JAX package's ``data/datasets.py``:

* PLY readers with the reference's label shifts (treeins: ``semantic_seg``-1,
  ``treeID``+1; npm3d: ``scalar_class``-1, ``scalar_label``+1);
* one-time preprocessing: ``origin_id`` provenance + grid subsampling,
  cached as .npz;
* training sampling: sqrt-class-balanced random cylinders (or spheres)
  around the centres of a radius-sized grid, rejecting tree-less cylinders
  for forests;
* test tiling: a PCA-aligned grid of overlapping cylinders (or spheres).

Neighbourhood queries go through scipy's cKDTree (the JAX package's
optional C++ ``Grid2D`` returns the same sorted rows). Every draw comes from
the ``np.random.Generator`` passed in, in the JAX package's order, so one
seed gives the same tiles in both packages.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree

from .labels import set_extra_labels
from .ply import read_ply
from .transform_pipeline import (
    DEFAULT_TEST_TRANSFORMS,
    DEFAULT_TRAIN_TRANSFORMS,
    TileState,
    build_pipeline,
)
from .voxelize import grid_sample


def read_treeins_format(path: str):
    data = read_ply(path)
    pos = np.stack([data["x"], data["y"], data["z"]], 1).astype(np.float32)
    if "semantic_seg" not in data:  # unlabeled (forward-only) file
        n = len(pos)
        return pos, -np.ones(n, np.int64), np.zeros(n, np.int64)
    y = data["semantic_seg"].astype(np.int64) - 1
    inst = data["treeID"].astype(np.int64) + 1
    return pos, y, inst


def read_npm3d_format(path: str):
    data = read_ply(path)
    pos = np.stack([data["x"], data["y"], data["z"]], 1).astype(np.float32)
    if "scalar_class" not in data:  # unlabeled (forward-only) file
        n = len(pos)
        return pos, -np.ones(n, np.int64), np.zeros(n, np.int64)
    y = data["scalar_class"].astype(np.int64) - 1
    inst = data["scalar_label"].astype(np.int64) + 1
    return pos, y, inst


@dataclasses.dataclass
class DatasetSpec:
    name: str
    num_classes: int
    stuff_classes: Tuple[int, ...]
    thing_classes: Tuple[int, ...]
    reader: Callable
    require_thing_in_tile: bool  # treeins rejects tree-less cylinders


TREEINS_SPEC = DatasetSpec(
    name="treeins",
    num_classes=2,
    stuff_classes=(0,),
    thing_classes=(1,),
    reader=read_treeins_format,
    require_thing_in_tile=True,
)

NPM3D_SPEC = DatasetSpec(
    name="npm3d",
    num_classes=9,
    stuff_classes=(0, 1, 5),
    thing_classes=(2, 3, 4, 6, 7, 8),
    reader=read_npm3d_format,
    require_thing_in_tile=False,
)


class PanopticFileDataset:
    """A split (train/val/test) backed by a list of .ply files."""

    def __init__(
        self,
        spec: DatasetSpec,
        files: Sequence[str],
        grid_size: float,
        radius: float,
        processed_dir: Optional[str] = None,
        max_instances: int = 64,
        keep_raw: bool = False,
        rng: Optional[np.random.Generator] = None,
        sampling_format: str = "cylinder",
        train_transforms: Optional[Sequence[dict]] = None,
        test_transforms: Optional[Sequence[dict]] = None,
        pre_collate_transform: Optional[Sequence[dict]] = None,
    ):
        """``rng`` draws the load-time grid subsampling ("last" mode) and the
        sampling centres' grid; the transform lists default to the paper's
        stacks."""
        if sampling_format not in ("cylinder", "sphere"):
            raise ValueError(f"sampling_format must be cylinder or sphere, got {sampling_format!r}")
        self.spec = spec
        self.files = list(files)
        self.grid_size = grid_size
        self.radius = radius
        self.max_instances = max_instances
        self.keep_raw = keep_raw
        self.sampling_format = sampling_format
        self._rng = rng or np.random.default_rng(2022)
        self._train_pipe = build_pipeline(
            DEFAULT_TRAIN_TRANSFORMS if train_transforms is None else train_transforms,
            grid_size)
        self._test_pipe = build_pipeline(
            DEFAULT_TEST_TRANSFORMS if test_transforms is None else test_transforms,
            grid_size)
        # pre-collate: SaveOriginalPosId is implicit (origin ids are always
        # recorded); GridSampling3D sets the load-time subsample mode
        self._load_mode = "last"
        for entry in pre_collate_transform or []:
            name = entry.get("transform") or entry.get("name")
            if name == "SaveOriginalPosId":
                continue
            if name == "GridSampling3D":
                self._load_mode = (entry.get("params") or {}).get("mode", "last")
            elif name != "PointCloudFusion":  # files are already per-area
                raise ValueError(f"unsupported pre_collate transform {name!r}")
        self.processed_dir = processed_dir
        if processed_dir:
            os.makedirs(processed_dir, exist_ok=True)

        self.clouds: List[Dict[str, np.ndarray]] = []
        self.raw_clouds: List[Dict[str, np.ndarray]] = []
        for f in self.files:
            self.clouds.append(self._load_file(f))
        self._build_sampling_tables()

    def _load_file(self, path: str) -> Dict[str, np.ndarray]:
        cache = None
        if self.processed_dir:
            base = osp.splitext(osp.basename(path))[0]
            cache = osp.join(self.processed_dir, f"{base}_g{self.grid_size:g}.npz")
        if cache and osp.exists(cache):
            z = np.load(cache)
            cloud = {k: z[k] for k in z.files}
        else:
            pos, y, inst = self.spec.reader(path)
            origin_id = np.arange(len(pos), dtype=np.int64)
            sub_pos, sub = grid_sample(
                pos,
                {"y": y, "instance_labels": inst, "origin_id": origin_id},
                self.grid_size,
                mode=self._load_mode,
                rng=self._rng,
            )
            cloud = {"pos": sub_pos, **sub}
            if cache:
                np.savez_compressed(cache, **cloud)
        if self.keep_raw:
            pos, y, inst = self.spec.reader(path)
            self.raw_clouds.append({"pos": pos, "y": y, "instance_labels": inst})
        return cloud

    def _build_sampling_tables(self) -> None:
        """Query trees (xy for cylinders, xyz for spheres) and the sampling
        centres: each cloud subsampled on a radius-sized grid, with the
        file index and the label of each centre, and the sqrt-balanced
        probability of each label."""
        cols = 3 if self.sampling_format == "sphere" else 2
        self._trees = [cKDTree(c["pos"][:, :cols]) for c in self.clouds]
        centres = []
        for i, c in enumerate(self.clouds):
            low_pos, low = grid_sample(
                c["pos"], {"y": c["y"]}, self.radius, mode="last", rng=self._rng
            )
            t = np.zeros((len(low_pos), 5), np.float64)
            t[:, :3] = low_pos
            t[:, 3] = i
            t[:, 4] = low["y"]
            centres.append(t)
        self._centres = np.concatenate(centres) if centres else np.zeros((0, 5))
        labels, counts = np.unique(self._centres[:, 4], return_counts=True)
        if len(labels):
            w = np.sqrt(counts.mean() / counts)
            self._label_probs = w / w.sum()
            self._labels = labels
        else:
            self._label_probs, self._labels = None, None

    def _query_tile(self, file_idx: int, centre: np.ndarray) -> Dict[str, np.ndarray]:
        """All points within ``radius`` of ``centre``: a vertical cylinder
        (xy query) or a sphere (xyz query) per ``sampling_format``."""
        q = centre[:3] if self.sampling_format == "sphere" else centre[:2]
        idx = np.asarray(sorted(self._trees[file_idx].query_ball_point(q, self.radius)),
                         dtype=np.int64)
        c = self.clouds[file_idx]
        return {k: v[idx] for k, v in c.items()}

    def sample_train_tile(self, rng: np.random.Generator, max_tries: int = 50) -> dict:
        """A training tile around a random centre: a label drawn with the
        sqrt-balanced probabilities, then one of its centres; a tile of
        fewer than 10 points (or, for forests, without a thing point) is
        drawn again, up to ``max_tries`` times."""
        if self._labels is None:
            raise ValueError("empty dataset: no sampling centres")
        for _ in range(max_tries):
            lab = rng.choice(self._labels, p=self._label_probs)
            valid = self._centres[self._centres[:, 4] == lab]
            centre = valid[int(rng.random() * (len(valid) - 1))]
            tile = self._query_tile(int(centre[3]), centre[:3])
            if len(tile["pos"]) < 10:
                continue
            if self.spec.require_thing_in_tile and not np.isin(
                tile["y"], self.spec.thing_classes
            ).any():
                continue
            return self._make_tile(tile, rng, train=True)
        raise RuntimeError("could not sample a valid cylinder")

    def _make_tile(self, tile: Dict[str, np.ndarray], rng, train: bool) -> dict:
        pipe = self._train_pipe if train else self._test_pipe
        st = TileState(
            pos=tile["pos"].astype(np.float32),
            attrs={
                "y": tile["y"].astype(np.int32),
                "instance_labels": tile["instance_labels"].astype(np.int32),
                "origin_id": tile["origin_id"].astype(np.int32),
            },
            train=train,
        )
        # geometric phase first: vote offsets are bbox centres of the
        # augmented positions, and subsetting transforms run before the
        # instance ids are compacted
        pipe.run_geometric(st, rng)
        extra = set_extra_labels(
            st.pos, st.attrs["y"], st.attrs["instance_labels"],
            self.spec.thing_classes, self.max_instances,
        )
        st.attrs["instance_labels"] = extra["instance_labels"]
        st.attrs["vote_label"] = extra["vote_label"]
        pipe.run_finalize(st, rng)
        if st.coords is None:
            raise ValueError(
                "transform pipeline produced no voxel coords: the test/train list "
                "needs GridSampling3D with quantize_coords: True"
            )
        out = dict(st.attrs)
        out["feats"] = st.feats
        out["coords"] = st.coords
        out["pos"] = st.pos
        out["num_instances"] = int(out["instance_labels"].max()) if len(
            out["instance_labels"]) else 0
        return out

    def test_tiles(
        self,
        file_idx: int,
        rng: Optional[np.random.Generator] = None,
        grid_shift: float = 0.0,
    ):
        """PCA-aligned grid tiling; returns [(tile dict, tile origin ids)].

        ``grid_shift`` (in [0, 1), fraction of the tile step) offsets the grid
        origin: voting runs use different shifts so that the re-tilings give
        different predictions to vote over."""
        rng = rng or np.random.default_rng(0)
        c = self.clouds[file_idx]
        xy = c["pos"][:, :2].astype(np.float64)
        mean = xy.mean(0)
        cov = np.cov((xy - mean).T)
        _, vecs = np.linalg.eigh(cov)
        comps = vecs[:, ::-1].T  # principal first
        reduced = (xy - mean) @ comps.T
        mins, maxs = reduced.min(0), reduced.max(0)
        step = self.radius
        off = (grid_shift % 1.0) * step
        if self.sampling_format == "sphere":
            z = c["pos"][:, 2]
            z_steps = np.arange(z.min() - off, z.max() + step, step)
        else:
            z_steps = np.array([0.0])
        tiles = []
        for cx in np.arange(mins[0] - off, maxs[0] + step, step):
            for cy in np.arange(mins[1] - off, maxs[1] + step, step):
                for cz in z_steps:
                    centre_xy = np.array([cx, cy]) @ comps + mean
                    centre = np.array([centre_xy[0], centre_xy[1], cz])
                    tile = self._query_tile(file_idx, centre)
                    if len(tile["pos"]) == 0:
                        continue
                    tiles.append((self._make_tile(tile, rng, train=False),
                                  tile["origin_id"].astype(np.int64)))
        return tiles

    @property
    def num_classes(self) -> int:
        return self.spec.num_classes

    def class_weights(self) -> np.ndarray:
        """sqrt-inverse-frequency class weights over the loaded clouds,
        normalized to sum to the class count."""
        counts = np.zeros(self.spec.num_classes, np.float64)
        for c in self.clouds:
            y = c["y"]
            y = y[y >= 0]
            counts += np.bincount(y, minlength=self.spec.num_classes)
        w = 1.0 / np.sqrt(np.maximum(counts, 1.0))
        return (w / w.sum() * self.spec.num_classes).astype(np.float32)
