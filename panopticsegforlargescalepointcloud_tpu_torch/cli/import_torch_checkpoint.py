"""Import a reference torch-points3d checkpoint (.pt) into a port checkpoint:

    python3 -m panopticsegforlargescalepointcloud_tpu_torch.cli.import_torch_checkpoint \\
        ref.pt out_dir [--weight-set latest] [--offset-perm 0,1,...] [--no-me-order]

The counterpart of the repo's ``tools/import_torch_checkpoint.py``, with the
same arguments, that needs neither JAX nor flax. It reads the reference's
file (``models: {<weight set>: state_dict}``, ``run_config``), carries the
weight set through :func:`..weights.params_from_reference` at the paper
plan (7 downs, 7 ups, 2 blocks; ScoreNet 2/2/2) and writes
``out_dir/model.pt``, a :class:`..train.checkpoint.ModelCheckpoint` whose
``latest`` set is ``{"state_dict": ...}`` and whose run config is the
reference's. The eval and forward CLIs then serve it
(``cli.eval checkpoint_dir=out_dir ...``).

ME's x-fastest kernel order is permuted into the port's by default
(``--me-order``); ``--no-me-order`` keeps the stored order and
``--offset-perm`` gives the permutation outright. The port reads its
checkpoints with ``weights_only=True``, so the run config must be plain
dicts, lists and scalars: any other type (an OmegaConf node, say) stops the
import with its name. The conversion runs on the host; no device is used.
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

import numpy as np
import torch

from ..train.checkpoint import ModelCheckpoint
from ..weights import me_to_ours_perm, params_from_reference

log = logging.getLogger(__name__)

_PLAIN = (str, int, float, bool, type(None))


class _ReadKeys(dict):
    """A state dict that records the keys read from it."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def check_plain(value, where: str = "run_config") -> None:
    """Raise TypeError naming the first value under ``value`` that is not a
    dict, list, tuple, str, int, float, bool or None."""
    if isinstance(value, dict):
        for k, v in value.items():
            if not isinstance(k, _PLAIN):
                raise TypeError(f"{where}: key {k!r} of type {type(k).__name__}")
            check_plain(v, f"{where}.{k}")
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            check_plain(v, f"{where}[{i}]")
    elif not isinstance(value, _PLAIN):
        raise TypeError(f"{where} is a {type(value).__module__}.{type(value).__qualname__}; "
                        "a port checkpoint keeps plain dicts, lists and scalars only")


def main(argv: Optional[List[str]] = None) -> str:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("out_dir")
    ap.add_argument("--weight-set", default="latest")
    ap.add_argument("--offset-perm", default=None,
                    help="comma-separated K permutation for ME kernel regions")
    ap.add_argument("--me-order", action=argparse.BooleanOptionalAction, default=True,
                    help="apply the ME x-fastest -> z-fastest kernel permutation "
                    "(me_to_ours_perm); --no-me-order for kernels already in the port's "
                    "order; --offset-perm overrides both")
    args = ap.parse_args(argv)

    blob = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    run_config = blob.get("run_config", {})
    check_plain(run_config)
    sd = _ReadKeys(blob["models"][args.weight_set])
    if args.offset_perm:
        perm = np.array([int(x) for x in args.offset_perm.split(",")])
    elif args.me_order:
        perm = me_to_ours_perm(3)
    else:
        perm = None
    state_dict = params_from_reference(sd, offset_perm=perm)
    unread = sorted(set(sd) - sd.read)
    log.info("%d tensors imported, %d reference keys not read (%s)", len(state_dict),
             len(unread), ", ".join(sorted({k.rsplit(".", 1)[-1] for k in unread})) or "-")
    ck = ModelCheckpoint(args.out_dir, run_config=run_config)
    ck.save_best_models_under_current_metrics({"state_dict": state_dict}, None, {})
    print(f"imported {args.weight_set} -> {ck.path}")
    return ck.path


if __name__ == "__main__":
    main()
