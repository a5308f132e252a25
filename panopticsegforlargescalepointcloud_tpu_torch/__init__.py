"""PyTorch + CUDA port of the panoptic segmentation framework for one NVIDIA H100.

Mirrors the layout of the JAX package (``config/``, ``data/``, ``ops/``,
``models/``, ``cluster/``, ``eval/``, ``train/``, ``parallel/``, ``utils/``,
``cli/``) so each module has a counterpart of the same name; ``parallel/``
runs data-parallel training and serving over ``torch.distributed``, one
process per rank. Plain tensor code is PyTorch; the sparse-conv forward, the
dense min-label pull and the mean-shift update are hand-written CUDA kernels
under ``csrc/``, built with ``nvcc`` on first use (see :mod:`._cuda`).

Entry points (:func:`train.step.make_eval_forward`,
:func:`train.step.canonicalize`, :func:`ops.hierarchy.build_hierarchy`) run
on ``cuda`` unless the caller passes ``device="cpu"``; without a GPU they
raise instead of carrying on.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
