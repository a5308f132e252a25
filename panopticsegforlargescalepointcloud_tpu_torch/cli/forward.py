"""Inference CLI on (possibly unlabeled) point clouds from a checkpoint, the
counterpart of the repo's ``forward_scripts/forward.py``:

    python3 -m panopticsegforlargescalepointcloud_tpu_torch.cli.forward \\
        checkpoint_dir=outputs/run1 "data.files.test=[scan.ply]" out_dir=fwd_out \\
        [tiles_per_dispatch=1] [device=cpu]

Rebuilds the model from the checkpoint's run config as the eval CLI does,
runs the full-scene prediction of each file (tiling, eval forward, block
merging at threshold 0.1, finalise) and writes ``<base>_pred.ply`` with
``x y z pred_sem pred_ins`` per raw point. No metrics are computed (use the
eval CLI on labeled data). At ``tiles_per_dispatch=1`` the labels are those
of the JAX package's forward script, which walks the tiles one by one.
Runs on ``cuda`` unless ``device=cpu``; without a GPU it raises.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import sys
from typing import Dict, List, Optional

import numpy as np

from ..data.ply import write_ply
from .eval import build_evaluator


def main(argv: Optional[List[str]] = None) -> Dict[str, str]:
    """Returns {input file: written PLY}."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    overrides = [a for a in (sys.argv[1:] if argv is None else argv) if "=" in a]
    if not any(o.startswith("out_dir=") for o in overrides):
        overrides.append("out_dir=forward_outputs")
    evaluator, _, out_dir, files = build_evaluator(overrides)
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for fi, path in enumerate(files):
        sem, ins, _ = evaluator.predict(fi, th_merge=0.1)
        raw = evaluator.dataset.raw_clouds[fi]
        base = osp.splitext(osp.basename(path))[0]
        written[path] = osp.join(out_dir, f"{base}_pred.ply")
        write_ply(written[path], [raw["pos"], sem.astype(np.int16), ins.astype(np.int32)],
                  ["x", "y", "z", "pred_sem", "pred_ins"])
        logging.info("%s: %d semantic classes, %d instances", base, len(np.unique(sem)),
                     len(np.unique(ins[ins >= 0])))
    return written


if __name__ == "__main__":
    main()
