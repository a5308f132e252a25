"""Faults planted in the program's timed path, underneath the harness,
for the tests that see ``correct`` come out false and for the chip
readings that set the limits' upper ends. Each patches the port's entry
point that the drivers look up when they set up, and returns an undo."""

from __future__ import annotations

from typing import Callable

import numpy as np


def _patch(module, name: str, make: Callable) -> Callable[[], None]:
    original = getattr(module, name)
    setattr(module, name, make(original))
    return lambda: setattr(module, name, original)


def frozen_state() -> Callable[[], None]:
    """The train step computes and returns its metrics but leaves the
    weights and the optimizer's state unchanged."""
    import panopticsegforlargescalepointcloud_tpu_torch.train as train

    def make(original):
        def make_train_step(cfg, model, optimizer, *a, **kw):
            step = original(cfg, model, optimizer, *a, **kw)

            def frozen(arrays, bn_momentum=0.1):
                state = {k: v.clone() for k, v in model.state_dict().items()}
                opt = optimizer.state_dict()
                metrics = step(arrays, bn_momentum)
                model.load_state_dict(state)
                optimizer.load_state_dict(opt)
                return metrics
            return frozen
        return make_train_step
    return _patch(train, "make_train_step", make)


def half_batch() -> Callable[[], None]:
    """The train step sees only the first half of the batch's samples: the
    others' rows are masked out, so that the losses are means over the
    rest."""
    import panopticsegforlargescalepointcloud_tpu_torch.train as train

    def make(original):
        def make_train_step(*a, **kw):
            step = original(*a, **kw)

            def halved(arrays, bn_momentum=0.1):
                coords, batch, mask, *rest = arrays
                n = int(batch.max()) + 1
                keep = mask & (batch < max(n // 2, 1))
                return step((coords, batch, keep, *rest), bn_momentum)
            return halved
        return make_train_step
    return _patch(train, "make_train_step", make)


def altered_answer(share: float = 0.01) -> Callable[[], None]:
    """Every served scene's labels altered where they are produced: the
    semantic class of ``share`` of the points (every 1/share-th) moved to
    the next class, before the report and the PLYs are written."""
    from panopticsegforlargescalepointcloud_tpu_torch.train import evaluator

    def make(original):
        def predict(self, *a, **kw):
            sem, ins, acc = original(self, *a, **kw)
            sem = np.array(sem)
            idx = np.arange(0, len(sem), max(int(round(1 / share)), 1))
            sem[idx] = (sem[idx] + 1) % max(self.pcfg.num_classes, 2)
            return sem, ins, acc
        return predict
    return _patch(evaluator.FullSceneEvaluator, "predict", make)


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
