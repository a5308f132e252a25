"""The frozen operation and byte count against a brute-force count."""

import itertools

import numpy as np
import pytest

from benchmark import counts

OFFSETS = list(itertools.product((-1, 0, 1), repeat=3))


def _cloud(seed, n=300, span=6):
    rng = np.random.default_rng(seed)
    coords = rng.integers(-span, span, size=(n, 3))
    batch = rng.integers(0, 2, size=n)
    return batch, coords


def _brute_levels(batch, coords, num_down):
    lv = [sorted({(int(b), *map(int, c)) for b, c in zip(batch, coords)})]
    for _ in range(num_down):
        lv.append(sorted({(b, x // 2, y // 2, z // 2) for b, x, y, z in lv[-1]}))
    return lv


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairs_match_brute_force(seed):
    batch, coords = _cloud(seed)
    lv = counts.levels(batch, coords, 3)
    brute = _brute_levels(batch, coords, 3)
    assert [len(b) for b, _ in lv] == [len(x) for x in brute]
    for (b, c), want in zip(lv, brute):
        have = set(want)
        same = sum((v[0], v[1] + o[0], v[2] + o[1], v[3] + o[2]) in have
                   for v in want for o in OFFSETS)
        assert counts.same_pairs(b, c) == same
    for lo in range(3):
        fine = set(brute[lo])
        down = sum((v[0], 2 * v[1] + o[0], 2 * v[2] + o[1], 2 * v[3] + o[2]) in fine
                   for v in brute[lo + 1] for o in OFFSETS)
        assert counts.down_pairs(lv[lo], lv[lo + 1]) == down


def test_paper_unet_convs_and_ops():
    from benchmark.reference.plain.models.plans import paper_backbone_plan

    batch, coords = _cloud(3, n=2000, span=20)
    plan = paper_backbone_plan(4, 16)
    lv = counts.levels(batch, coords, 6)
    convs = counts.unet_convs(lv, plan["down_channels"], plan["up_channels"],
                              plan["down_strides"], plan["up_strides"], plan["num_blocks"])
    sparse = [c for c in convs if not c.name.endswith(".dense")]
    assert len(sparse) == 70  # 14 blocks of a first conv and two ResBlocks of two convs
    # a width-changing first ResBlock in each strided block has a 1x1 shortcut
    assert len(convs) - len(sparse) == 12
    c = sparse[0]
    assert (c.cin, c.cout, c.pairs) == (4, 16, counts.same_pairs(*lv[0]))
    assert counts.conv_ops(c) == 2.0 * c.pairs * 4 * 16
    assert counts.conv_bytes(c) == (c.rows_in * 4 + 27 * 4 * 16) * 2 + c.rows_out * (27 + 16) * 4
    fc = counts.forward_count(batch, coords, plan, (9, 3, 5), 16, 989e12, 3.35e12)
    heads = 2.0 * len(lv[0][0]) * (3 * 256 + 16 * 17)
    assert fc.conv_ops == sum(counts.conv_ops(x) for x in sparse)
    assert fc.model_ops == pytest.approx(sum(counts.conv_ops(x) for x in convs) + heads)
    assert fc.conv_bound_s >= fc.conv_ops / 989e12


def test_counts_add_up_over_samples():
    batch, coords = _cloud(4, n=800, span=10)
    plan = dict(down_channels=((4, 8), (8, 16)), up_channels=((16, 8), (16, 8)),
                down_strides=(1, 2), up_strides=(2, 1), num_blocks=1)
    whole = counts.forward_count(batch, coords, plan, (2,), 8, 1e12, 1e12).model_ops
    parts = sum(counts.forward_count(batch[batch == b] * 0, coords[batch == b], plan, (2,), 8,
                                     1e12, 1e12).model_ops for b in (0, 1))
    assert whole == pytest.approx(parts)
