"""What the program's forward produced, recorded while it runs.

:class:`ForwardCapture` wraps the port's ``train.step.panoptic_forward``
(the forward of the train step and of the eval forward alike), passes
every call through unchanged, and keeps, while active, each call's
canonical rows (positions, sample, mask, origin) and outputs: the heads
(semantic log-probabilities, offsets, embeddings), the proposals and the
ScoreNet's scores, as detached copies on the device, so that recording
never waits for it (:func:`.reference.stages.record`). The reference judges
these once the window has closed and follows the program's proposals from
there (:mod:`.reference.stages`).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from .reference.stages import record


class ForwardCapture:
    def __init__(self):
        self.calls: List[Dict] = []
        self._undo: Callable[[], None] | None = None

    def __enter__(self) -> "ForwardCapture":
        from panopticsegforlargescalepointcloud_tpu_torch.train import step

        original = step.panoptic_forward

        def panoptic_forward(cfg, model, db, hier, *args, **kwargs):
            out = original(cfg, model, db, hier, *args, **kwargs)
            with torch.no_grad():
                self.calls.append(record(db, out))
            return out

        step.panoptic_forward = panoptic_forward
        self._undo = lambda: setattr(step, "panoptic_forward", original)
        return self

    def __exit__(self, *exc) -> None:
        self._undo()
