"""The last host copies: ``eval/merge.py:block_merging_by_score`` (the
reference's score-ordered NMS merger, which no pipeline calls) and
``utils/geometry.py`` against the JAX package's, on seeded random inputs:
the kept pools and scores identical, the rotations, box volumes and IoUs
and instance boxes equal."""

import numpy as np
import pytest

from panopticsegforlargescalepointcloud_tpu.eval.merge import (
    block_merging_by_score as j_merge_by_score,
)
from panopticsegforlargescalepointcloud_tpu.utils import geometry as j_geometry
from panopticsegforlargescalepointcloud_tpu_torch.eval.merge import block_merging_by_score
from panopticsegforlargescalepointcloud_tpu_torch.utils import geometry


def _tile(rng, full_pos, n_clusters):
    """A tile: its full-resolution rows, a subsample of them and clusters
    over the subsample's rows, with scores."""
    full_ids = np.sort(rng.choice(len(full_pos), size=300, replace=False))
    sub_ids = np.sort(rng.choice(full_ids, size=120, replace=False))
    clusters = [np.unique(rng.integers(0, len(sub_ids), size=rng.integers(5, 40)))
                for _ in range(n_clusters)]
    return full_ids, sub_ids, clusters, rng.random(n_clusters)


def _same(got, want):
    (gc, gs), (wc, ws) = got, want
    assert len(gc) == len(wc)
    for a, b in zip(gc, wc):
        np.testing.assert_array_equal(a, b)
    if ws is None:
        assert gs is None
    else:
        np.testing.assert_array_equal(gs, ws)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("nms", [0.1, 0.3])
def test_two_tiles_onto_a_pool_match_jax(seed, nms):
    """A first tile onto an empty pool (``all_scores`` None), then a second
    tile onto the kept pool."""
    rng = np.random.default_rng(seed)
    full_pos = rng.uniform(0, 10, (600, 3)).astype(np.float32)
    got = want = ([], None)
    for _ in range(2):
        full_ids, sub_ids, clusters, scores = _tile(rng, full_pos, 8)
        got = block_merging_by_score(got[0], got[1], clusters, scores, full_pos, full_ids,
                                     sub_ids, nms_threshold=nms)
        want = j_merge_by_score(want[0], want[1], clusters, scores, full_pos, full_ids,
                                sub_ids, nms_threshold=nms)
        _same(got, want)
    assert 0 < len(got[0]) <= 16


def test_empty_new_clusters_keep_the_pool():
    rng = np.random.default_rng(5)
    full_pos = rng.uniform(0, 10, (600, 3)).astype(np.float32)
    full_ids, sub_ids, clusters, scores = _tile(rng, full_pos, 4)
    pool = block_merging_by_score([], None, clusters, scores, full_pos, full_ids, sub_ids)
    for start in (([], None), pool):
        got = block_merging_by_score(start[0], start[1], [], None, full_pos, full_ids, sub_ids)
        want = j_merge_by_score(start[0], start[1], [], None, full_pos, full_ids, sub_ids)
        _same(got, want)
        assert got[0] is start[0] and got[1] is start[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_geometry_matches_jax(seed):
    rng = np.random.default_rng(seed)
    axis, theta = rng.normal(size=3), float(rng.uniform(-np.pi, np.pi))
    np.testing.assert_array_equal(geometry.rodrigues(axis, theta),
                                  j_geometry.rodrigues(axis, theta))
    rot = geometry.rodrigues(axis, theta)
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-12)
    lo = rng.uniform(0, 5, (2, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.5, 3, (2, 3))], 1)
    for b in boxes:
        assert geometry.box_volume(b) == j_geometry.box_volume(b)
    assert geometry.box_iou(*boxes) == j_geometry.box_iou(*boxes)
    assert geometry.box_iou(boxes[0], boxes[0]) == 1.0
    pos = rng.normal(size=(200, 3))
    labels = rng.integers(-1, 5, 200)
    got, want = geometry.instance_boxes(pos, labels), j_geometry.instance_boxes(pos, labels)
    assert sorted(got) == sorted(want) and 0 not in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
