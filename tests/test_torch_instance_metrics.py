"""The validation epochs' instance metrics of the port against the JAX
package's (``eval/instance_metrics.py``): ``compute_acc``, ``compute_eval``,
``voc_ap`` and ``InstanceAPMeter`` on fixed random scenes (several samples
of a batch, ground-truth instances of several classes, clusters that
overlap them more or less, empty and unlabeled cases). Tolerance: exact (the
same numpy arithmetic)."""

import numpy as np
import pytest

from panopticsegforlargescalepointcloud_tpu.eval import instance_metrics as J
from panopticsegforlargescalepointcloud_tpu_torch.eval import instance_metrics as P

THINGS = (2, 3, 4, 6, 7, 8)


def _scene(seed, n=600, samples=3, n_inst=12, n_clusters=10, num_classes=9):
    """(clusters, pred, inst, y, batch) of a batch of ``samples`` scans:
    ground-truth instances of random thing classes, clusters drawn around
    them (some shifted, some random) and predictions that agree in part."""
    rng = np.random.default_rng(seed)
    batch = np.sort(rng.integers(0, samples, n)).astype(np.int32)
    batch[-20:] = -1  # padding rows
    y = rng.choice([0, 1, 5], n).astype(np.int32)
    inst = np.zeros(n, np.int32)
    for g in range(1, n_inst + 1):
        rows = rng.choice(np.where(batch >= 0)[0], size=rng.integers(10, 40), replace=False)
        s = batch[rows[0]]
        rows = rows[batch[rows] == s]
        inst[rows] = g
        y[rows] = rng.choice(THINGS)
    y[rng.random(n) < 0.03] = -1
    pred = np.where(rng.random(n) < 0.8, np.maximum(y, 0), rng.integers(0, num_classes, n))
    clusters = []
    for _ in range(n_clusters):
        g = rng.integers(1, n_inst + 1)
        rows = np.where(inst == g)[0]
        if rng.random() < 0.3 or len(rows) == 0:
            s = rng.integers(0, samples)
            rows = rng.choice(np.where(batch == s)[0], size=15, replace=False)
        else:
            keep = rows[rng.random(len(rows)) < 0.8]
            extra = rng.choice(np.where(batch == batch[rows[0]])[0], size=5, replace=False)
            rows = np.unique(np.concatenate([keep, extra]))
        clusters.append(np.sort(rows))
    return clusters, pred.astype(np.int64), inst, y, batch


@pytest.mark.parametrize("seed", range(6))
def test_compute_acc_matches_jax(seed):
    clusters, pred, inst, y, batch = _scene(seed)
    ninst = int(np.unique(inst * (batch >= 0)).max())
    for thr in (0.5, 0.25):
        assert P.compute_acc(clusters, pred, inst, y, batch, ninst, thr) == J.compute_acc(
            clusters, pred, inst, y, batch, ninst, thr)


@pytest.mark.parametrize("seed", range(6))
def test_compute_eval_matches_jax(seed):
    clusters, pred, inst, y, batch = _scene(seed)
    got = P.compute_eval(clusters, pred, inst, y, batch, 9, THINGS)
    assert got == J.compute_eval(clusters, pred, inst, y, batch, 9, THINGS)
    assert any(v > 0 for v in got)


def test_empty_cases_match_jax():
    clusters, pred, inst, y, batch = _scene(0)
    assert P.compute_acc([], pred, inst, y, batch, 5) == J.compute_acc([], pred, inst, y, batch, 5)
    no_gt = np.zeros_like(inst)
    assert P.compute_eval(clusters, pred, no_gt, y, batch, 9, THINGS) == J.compute_eval(
        clusters, pred, no_gt, y, batch, 9, THINGS)


def _instances(mod, clusters, pred, inst, y, batch, scores, offset):
    preds = [mod._Instance(int(np.bincount(pred[c]).argmax()), float(s), c,
                           int(batch[c[0]]) + offset) for c, s in zip(clusters, scores)]
    gts = []
    for s_id in np.unique(batch[batch >= 0]):
        smask = batch == s_id
        for g in np.unique(inst[smask]):
            if g <= 0:
                continue
            idxs = np.where((inst == g) & smask)[0]
            gts.append(mod._Instance(int(np.bincount(np.maximum(y[idxs], 0)).argmax()), -1.0,
                                     idxs, int(s_id) + offset))
    return preds, gts


@pytest.mark.parametrize("thr", [0.25, 0.5])
def test_ap_meter_matches_jax(thr):
    meters = P.InstanceAPMeter(), J.InstanceAPMeter()
    offset = 0
    for seed in range(3):  # three batches accumulated, scan ids offset
        clusters, pred, inst, y, batch = _scene(10 + seed)
        scores = np.random.default_rng(seed).random(len(clusters))
        for meter, mod in zip(meters, (P, J)):
            meter.add(*_instances(mod, clusters, pred, inst, y, batch, scores, offset))
        offset += int(batch.max()) + 1
    got, want = meters[0].eval(thr), meters[1].eval(thr)
    assert got[2] == want[2] and got[2]
    for a, b in zip(got[:2], want[:2]):
        assert set(a) == set(b)
        for c in a:
            np.testing.assert_array_equal(a[c], b[c])


def test_voc_ap_matches_jax():
    rng = np.random.default_rng(1)
    rec = np.sort(rng.random(20))
    prec = rng.random(20)
    assert P.voc_ap(rec, prec) == J.voc_ap(rec, prec)
