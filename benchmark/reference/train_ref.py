"""The reference's training steps: the plain copy's model, train step and
Adam, in f32 with TF32 off (or, for the precision control, with fp8 conv
operands), from the benchmark's weights and tiles."""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from .plain.config import panoptic_config_from_yaml, training_config_from_yaml
from .plain.data import batch_arrays, collate_tiles
from .plain.models import PointGroup3HeadsNet
from .plain.train import make_train_step
from .plain.train.optim import make_lr_schedule, make_optimizer
from .stages import Follow


class Steps(NamedTuple):
    losses: List[float]  # each step's total loss
    terms: List[Dict[str, float]]  # each step's loss terms
    first_grad: Dict[str, torch.Tensor]  # step 1's gradient, read from Adam's state
    params: Dict[str, torch.Tensor]  # the parameters after the last step
    calls: List[Dict]  # each step's forward (:func:`.stages.record`)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def model_config(run_config: dict, **kw):
    """The model configuration of ``run_config`` (its ``backbone`` and
    ``budget_overrides`` keys apply, as the eval CLI applies them)."""
    return panoptic_config_from_yaml(run_config, backbone=str(run_config.get("backbone", "paper")),
                                     **kw, **run_config.get("budget_overrides", {}))[0]


def adam_first_grad(optimizer: torch.optim.Optimizer, names: Dict[torch.nn.Parameter, str]
                    ) -> Dict[str, torch.Tensor]:
    """The gradient of the only step taken, from Adam's first moment:
    m_1 = (1 - beta1) g_1 (0 where Adam holds no state: it got none)."""
    out = {}
    for group in optimizer.param_groups:
        beta1 = group["betas"][0]
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            m = state["exp_avg"].detach() if "exp_avg" in state else torch.zeros_like(p)
            out[names[p]] = m.clone() / (1.0 - beta1)
    return out


def run_steps(run_config: dict, weights: Dict[str, torch.Tensor], batches: List[List[dict]],
              capacity: int, with_clustering: bool, compute_dtype: str = "float32",
              device: str = "cuda", proposals: Optional[List[Dict]] = None) -> Steps:
    """Train from ``weights`` over ``batches`` (lists of tile dicts), one
    step each, as the configuration states, with ``compute_dtype`` conv
    operands; with ``proposals`` (one table a step, :mod:`.stages`) the
    steps take those in place of their own clustering."""
    if device != "cpu":
        no_tf32()
    num = len(batches[0])
    cfg = model_config(run_config, num_samples=num, compute_dtype=compute_dtype)
    tc = training_config_from_yaml(run_config)
    model = PointGroup3HeadsNet(cfg)
    model.load_state_dict({k: v.to("cpu") for k, v in weights.items()}, strict=True)
    model.to(device)
    optimizer = make_optimizer(tc.optimizer, model.parameters(), tc.weight_decay)
    schedule = make_lr_schedule(tc.scheduler, tc.scheduler_params, tc.lr, tc.steps_per_epoch)
    step = make_train_step(cfg, model, optimizer, schedule, with_clustering,
                           tc.grad_clip_value, device=device)
    names = {p: n for n, p in model.named_parameters()}
    terms, first = [], None
    with Follow(proposals if with_clustering else None) as follow:
        for i, tiles in enumerate(batches):
            arrays = batch_arrays(collate_tiles(tiles, capacity=capacity, num_tiles=num))
            terms.append({k: float(v) for k, v in step(arrays, tc.bn_momentum).items()})
            if i == 0:
                first = adam_first_grad(optimizer, names)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return Steps([t["loss"] for t in terms], terms, first, params, follow.calls)
