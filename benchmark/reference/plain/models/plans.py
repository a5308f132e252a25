"""Channel plans for the paper's backbone and scorer networks (a copy of the
JAX package's ``models/plans.py``; the paper plan is the 7-level UNet of
``conf/models/panoptic/area4_ablation_3heads_5.yaml``)."""

from __future__ import annotations

from typing import Tuple


def paper_backbone_plan(feat: int = 4, in_feat: int = 16):
    """The 7-level paper backbone (Settings I-V).

    down_conv_nn: [FEAT, f], [f, 2f], ..., [6f, 7f], strides [1,2,2,2,2,2,2]
    up_conv_nn: [7f, 6f], [2*6f, 5f], ..., [2*2f, f], [2f, f], strides [2]*6+[1]
    """
    f = in_feat
    down = [(feat, f)] + [(i * f, (i + 1) * f) for i in range(1, 7)]
    down_strides = (1,) + (2,) * 6
    up = [(7 * f, 6 * f)]
    for i in range(6, 1, -1):
        up.append((2 * i * f, (i - 1) * f))
    up.append((2 * f, f))
    up_strides = (2,) * 6 + (1,)
    return dict(
        down_channels=tuple(down),
        up_channels=tuple(up),
        down_strides=down_strides,
        up_strides=tuple(up_strides),
        num_blocks=2,
    )


def tiny_backbone_plan(feat: int = 4, in_feat: int = 8):
    """A 3-level miniature of the paper backbone (CI / smoke tests)."""
    f = in_feat
    return dict(
        down_channels=((feat, f), (f, 2 * f), (2 * f, 3 * f)),
        up_channels=((3 * f, 2 * f), (2 * 2 * f, f), (2 * f, f)),
        down_strides=(1, 2, 2),
        up_strides=(2, 2, 1),
        num_blocks=1,
    )


def scorer_unet_plan(in_feat: int = 16):
    """ScorerUnet: 2 stride-2 downs, 2 ups (yaml lines 128-146)."""
    f = in_feat
    return dict(
        down_channels=((f, 2 * f), (2 * f, 4 * f)),
        up_channels=((4 * f, 2 * f), (4 * f, f)),
        down_strides=(2, 2),
        up_strides=(2, 2),
        num_blocks=2,
    )


def num_down_levels(strides: Tuple[int, ...]) -> int:
    return sum(1 for s in strides if s > 1)
