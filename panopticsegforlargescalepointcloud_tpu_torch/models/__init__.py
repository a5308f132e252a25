from .pointgroup3heads import (
    PanopticConfig,
    PanopticOutput,
    PointGroup3HeadsNet,
    Proposals,
    build_proposals,
    panoptic_losses,
    scorer_inputs,
)

__all__ = [
    "PanopticConfig", "PanopticOutput", "PointGroup3HeadsNet", "Proposals",
    "build_proposals", "panoptic_losses", "scorer_inputs",
]
