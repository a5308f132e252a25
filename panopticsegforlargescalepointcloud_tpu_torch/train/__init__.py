from .step import DeviceBatch, canonicalize, make_eval_forward, panoptic_forward

__all__ = ["DeviceBatch", "canonicalize", "make_eval_forward", "panoptic_forward"]
