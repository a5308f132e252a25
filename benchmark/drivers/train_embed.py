"""Closed-loop full train steps of the port's PointGroupEmbed model (the
paper's Setting I: semantic and embedding heads, mean shift on the
embedding as the only clustering, no ScoreNet).

The loop, the batches and the weights are :class:`.train.TrainCell`'s; what
differs is what the model has: its forward count has no offset head, and
the reference is the embed family's plain copy
(:mod:`..reference.embed`), which checks the semantic log-probabilities
and the embeddings, the strategy-7 clustering of the program's heads, and
the steps' losses, gradients and updates. In a traced run the profiled
steps' heads are kept (references to the forward's own tensors, no copy),
and after the window the plain reference rebuilds mean shift's operands
from them and counts kernel C's work (:mod:`..ms_counts`), the numerator of
``meanshift_roofline.train``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import counts, ms_counts
from ..reference import compare, embed, stages
from ..reference.embed.model import ms_operands
from ..reference.plain.cluster.meanshift import mean_shift
from ..reference.plain.config.schema import dataset_spec_from_cfg
from ..reference.plain.models.plans import paper_backbone_plan, tiny_backbone_plan
from . import train
from .common import HBM_BYTES_S, PEAK_FLOPS, Outcome


def forward_count(config: dict, batch: np.ndarray, coords: np.ndarray) -> counts.ForwardCount:
    """The frozen count of one forward of the embed model: the UNet's
    channel plan and two heads (semantic, embedding)."""
    run_config = config["run_config"]
    model = run_config["models"][run_config["model_name"]]
    f = int(model.get("feat_size", 16))
    tiny = run_config.get("backbone", "paper") == "tiny"
    plan = (tiny_backbone_plan if tiny else paper_backbone_plan)(4, f)
    classes = dataset_spec_from_cfg(run_config.get("data", {})).num_classes
    heads = (classes, int(model.get("embed_dim", 5)))
    return counts.forward_count(batch, coords, plan, heads, f, PEAK_FLOPS, HBM_BYTES_S)


def heads_gap(prog: Dict, ref: Dict) -> float:
    """The worst of the two heads' relative gaps (semantic
    log-probabilities, embeddings) over the valid rows (1 where the rows
    differ)."""
    if not stages.same_rows(prog, ref):
        return 1.0
    m = ref["mask"]
    return max(stages.rel_gap(prog[k].to(m.device)[m], ref[k][m]) for k in ("sem", "emb"))


def clustering_mismatch(cfg: embed.EmbedConfig, prog: Dict, device) -> float:
    """The share of proposal-table entries where the copy's strategy-7
    clustering of the program's rows and heads differs from the program's
    proposals."""
    dev = torch.device(device)
    args = [prog[k].to(dev) for k in ("pos", "off", "emb", "sem", "batch", "mask")]
    props, _, _ = embed.build_proposals(cfg, *args)
    want = prog["proposals"]
    bad = total = 0
    for k in stages.PROPOSAL_FIELDS:
        a, b = getattr(props, k), want[k].to(dev)
        total += b.numel()
        bad += b.numel() if a.shape != b.shape else int((a != b).sum())
    return bad / max(total, 1)


@torch.no_grad()
def ms_inputs(cfg: embed.EmbedConfig, h: Dict, device=None):
    """Mean shift's operands (x, valid, cols) of one forward, rebuilt by
    the plain copy from its recorded heads and rows; the positions'
    columns are zeroed in the operands, so zeros stand in for them."""
    h = {k: h[k].to(device) if device is not None else h[k]
         for k in ("emb", "sem", "batch", "mask")}
    pos = torch.zeros((h["emb"].shape[0], 3), dtype=torch.float32, device=h["emb"].device)
    x, valid, cols, _, _ = ms_operands(cfg, pos, h["emb"].float(), h["sem"], h["batch"],
                                       h["mask"])
    return x, valid, cols


@torch.no_grad()
def pack_stats(cfg: embed.EmbedConfig, prog: Dict, device) -> Dict[str, List[int]]:
    """Mean shift's work in one recorded forward, by the plain copy: each
    sample's packed points, valid seeds and centres, and the plain loop's
    passes."""
    x, valid, cols = ms_inputs(cfg, prog, torch.device(device))
    w = ms_counts.work(x, valid, cols, cfg.bandwidth, cfg.ms_max_seeds)
    ms = mean_shift(x, valid, bandwidth=cfg.bandwidth, max_seeds=cfg.ms_max_seeds, cols=cols)
    return dict(points=[int(v) for v in w.points], seeds=[int(v) for v in w.seeds],
                centres=[int(v) for v in ms.num_clusters.tolist()],
                passes=[int(v) for v in w.passes])


class EmbedTrainCell(train.TrainCell):
    def setup(self) -> None:
        self.heads: List[Dict] = []
        self._keep_heads = False
        super().setup()
        # the reference's configuration (f32), for its clustering and counts
        self.cfg = embed.embed_config_from_yaml(self.config["run_config"],
                                                num_samples=self.batch_tiles,
                                                compute_dtype="float32")

    def take(self, tiles: List[int]) -> Dict[str, float]:
        # the profiled steps are those taken while the profiler is on
        if not (self._keep_heads and torch._C._autograd._profiler_enabled()):
            return super().take(tiles)
        from panopticsegforlargescalepointcloud_tpu_torch.train import step

        original = step.panoptic_forward

        def panoptic_forward(cfg, model, db, hier, *args, **kwargs):
            out = original(cfg, model, db, hier, *args, **kwargs)
            self.heads.append(dict(emb=out.embed_logits.detach(),
                                   sem=out.semantic_logits.detach(),
                                   batch=db.grid.batch, mask=db.grid.mask))
            return out

        step.panoptic_forward = panoptic_forward
        try:
            return super().take(tiles)
        finally:
            step.panoptic_forward = original

    def window(self, seconds: float, profile: bool = False) -> Outcome:
        self._keep_heads = profile
        out = super().window(seconds, profile)
        self._keep_heads = False
        if out.layers is not None and out.layers.trace is not None and self.heads:
            cfg = self.cfg
            work = [ms_counts.work(*ms_inputs(cfg, h), cfg.bandwidth, cfg.ms_max_seeds)
                    for h in self.heads]
            out.layers.ms_bound_s = sum(ms_counts.bound_s(w, ms_counts.F32_PEAK_FLOPS,
                                                          HBM_BYTES_S) for w in work)
            out.lines.append(
                f"profiled mean shift: {len(work)} calls, points a sample "
                f"{[w.points for w in work]}, valid seeds {[w.seeds for w in work]}, "
                f"passes {[w.passes for w in work]}, least time {out.layers.ms_bound_s} s")
        self.heads = []
        return out

    def _count(self, batch: np.ndarray, coords: np.ndarray) -> counts.ForwardCount:
        return forward_count(self.config, batch, coords)

    def reference(self, compute_dtype: str = "float32"):
        """The reference's steps over the cell's first batches, from its
        initial weights, taking the program's proposals."""
        return embed.run_steps(self.config["run_config"], self.init,
                               [[self.pool[t] for t in b] for b in self.check_batches],
                               self.capacity, compute_dtype, self.device,
                               [c["proposals"] for c in self.calls])

    def check(self) -> Dict[str, float]:
        out = numbers(self, None, self.reference())
        out["clustering_mismatch"] = max(clustering_mismatch(self.cfg, c, self.device)
                                         for c in self.calls)
        return out


def numbers(cell, steps, ref) -> Dict[str, float]:
    """The compared numbers of ``steps`` (the program's where None) against
    ``ref``: :func:`.train.numbers`, with the two heads' gap, and the
    median leaf's gradient gap over the leaves on the step's path (those
    the reference's first gradient moves, as for the change's gaps): the
    ScoreNet's leaves, which no forward of this model uses, get a zero
    gradient on both sides and would pull the median of all leaves to 0."""
    if steps is None:
        terms, grad, params, calls = cell.terms, cell.first_grad, cell.after, cell.calls
    else:
        terms, grad, params, calls = steps.terms, steps.first_grad, steps.params, steps.calls
    out = train.numbers(terms, grad, params, cell.init, calls, ref)
    out["heads_gap"] = heads_gap(calls[0], ref.calls[0])
    dev = next(iter(ref.params.values())).device
    moved = compare.moved_leaves(ref.first_grad)
    grads = compare.leaf_gaps({k: v.to(dev) for k, v in grad.items()}, ref.first_grad,
                              keep=moved)
    out["grad_gap_median"] = float(np.median(list(grads.values())))
    return out


def run(config: dict, traffic: dict, seed: int, seconds: float, timer=None,
        profile: bool = False, device: str = "cuda") -> Outcome:
    cell = EmbedTrainCell(config, traffic, seed, timer, device)
    cell.setup()
    setup_end = time.perf_counter()
    if timer is not None:
        timer.spans.clear()
    out = cell.window(seconds, profile)
    out.setup_end = setup_end
    out.memory_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    cell.release()
    t_check = time.perf_counter()
    out.numbers = cell.check()
    stats = pack_stats(cell.cfg, cell.calls[0], device)
    out.lines.append(f"reference check took {time.perf_counter() - t_check} s")
    out.lines.append("mean shift pack, step 1: " + " ".join(f"{k} {v}" for k, v in stats.items()))
    return out
