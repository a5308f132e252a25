"""Full-scene evaluation on the host: instance extraction (NMS on device
IoU), block merging, the confusion matrix and the PQ report."""

from .confusion import ConfusionMatrix
from .extract import extract_clusters
from .merge import SceneAccumulator, block_merging
from .panoptic_quality import final_eval

__all__ = ["ConfusionMatrix", "SceneAccumulator", "block_merging", "extract_clusters",
           "final_eval"]
