"""The train step's backbone and heads replayed as CUDA graphs, forward and
backward.

A train step's sparse UNet and heads launch some 3,400 kernels forward and
4,300 backward, most of them a few microseconds of device work behind a
Python dispatch, so the host sets the pace. Every shape there is static:
the hierarchy's capacities are fixed per level and the conv kernels take
their plan from the shapes alone. So :func:`backbone_heads` captures the
forward (:meth:`..pointgroup3heads.PointGroup3HeadsNet.backbone_heads`) and
its backward once per input signature, and then replays them: two graph
launches and about 27 copies into the graphs' static inputs a step.

Engagement (:func:`engaged`) follows what the call can observe: a CUDA
device, a model in training mode, grad enabled, a sparse-UNet backbone and
no module hooks (a hook is Python, which a replay does not run). Everything
else stays eager: the point backbones, whose radius queries have
data-dependent sizes; every eval forward, serving included; every CPU run.

Capture runs the forward and backward a few times on a side stream first,
which moves the BN running statistics; :func:`snapshot` before and
:func:`restore` after put them back, so the step that captures computes
what the eager step would, by replay.
"""

from __future__ import annotations

import collections
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from .. import _cuda
from ..ops.hierarchy import Hierarchy
from ..ops.sparse import SparseGrid
from ..utils import trace
from .norm import momentum_tensor

WARMUP = 2  # forward and backward runs before capture
CACHE_SIZE = 4  # graph pairs kept per model, the least recently used dropped

_CACHES: "weakref.WeakKeyDictionary[nn.Module, collections.OrderedDict]" = (
    weakref.WeakKeyDictionary())


def engaged(model: nn.Module, device) -> bool:
    """Whether the backbone and heads of ``model`` run as graphs on
    ``device``: a CUDA device, training mode, grad enabled, the sparse UNet,
    and no module hooks."""
    return (torch.device(device).type == "cuda" and model.training
            and torch.is_grad_enabled() and not model.cfg.is_point_backbone
            and not any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
                        or m._backward_pre_hooks for m in model.modules()))


def graph_inputs(feats: torch.Tensor, momentum: torch.Tensor,
                 hier: Hierarchy) -> Tuple[torch.Tensor, ...]:
    """Everything the backbone and heads read of a step: the features, the
    BN momentum, each level's submanifold, down and up maps, and each
    level's grid mask."""
    return (feats, momentum, *hier.same_maps, *hier.down_maps, *hier.up_maps,
            *(g.mask for g in hier.grids))


def static_hierarchy(inputs: Sequence[torch.Tensor]) -> Hierarchy:
    """The hierarchy of :func:`graph_inputs`' tensors: the maps and masks,
    no coordinates, keys or parents."""
    levels = len(inputs) // 4  # 2 + L same maps + 2 (L - 1) down and up maps + L masks
    same, rest = inputs[2:2 + levels], inputs[2 + levels:]
    down, up, masks = rest[:levels - 1], rest[levels - 1:2 * levels - 2], rest[2 * levels - 2:]
    return Hierarchy(grids=tuple(SparseGrid(None, None, None, m) for m in masks),
                     same_maps=tuple(same), down_maps=tuple(down), up_maps=tuple(up),
                     parents=(), overflow=None)


def cache_key(model: nn.Module, inputs: Sequence[torch.Tensor]) -> tuple:
    """Every input's shape, dtype and device, the conv operands' dtype, and
    the addresses of the model's parameters (with whether each takes a
    gradient) and buffers: a moved or reloaded model captures again and
    never replays stale pointers."""
    return (tuple((tuple(t.shape), t.dtype, t.device) for t in inputs),
            model.cfg.compute_dtype,
            tuple((p.data_ptr(), p.requires_grad) for p in model.parameters()),
            tuple(b.data_ptr() for b in model.buffers()))


def snapshot(model: nn.Module) -> List[torch.Tensor]:
    """Copies of every buffer of ``model`` (the BN running statistics)."""
    return [b.detach().clone() for b in model.buffers()]


@torch.no_grad()
def restore(model: nn.Module, saved: Sequence[torch.Tensor]) -> None:
    """Write a :func:`snapshot` back, in place."""
    for b, s in zip(model.buffers(), saved):
        b.copy_(s)


def _launches() -> List[int]:
    return [k.launches for k in _cuda.KERNELS]


def _since(before: Sequence[int]) -> Dict[_cuda.Kernel, int]:
    return {k: n - b for k, n, b in zip(_cuda.KERNELS, _launches(), before) if n != b}


class _Graphs:
    """One captured pair: the forward graph, its backward, their static
    inputs, outputs, output gradients and parameter gradients, and the
    kernel launches each holds."""

    def __init__(self, model: nn.Module, inputs: Sequence[torch.Tensor],
                 params: Sequence[torch.Tensor]):
        def run(static):
            x, sem, off, emb, _ = model.backbone_heads(static[0], static_hierarchy(static),
                                                       static[1], pos=None)
            return x, sem, off, emb

        def backward(outs, grad_outs):
            diff = [o for o in outs if o.requires_grad]
            return torch.autograd.grad(diff, params, [g for g in grad_outs if g is not None],
                                       allow_unused=True)

        self.n_inputs = len(inputs)
        torch.cuda.synchronize()
        saved = snapshot(model)
        self.inputs = tuple(t.detach().clone() for t in inputs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                outs = run(self.inputs)
                backward(outs, [torch.zeros_like(o) if o.requires_grad else None
                                for o in outs])
        torch.cuda.synchronize()
        del outs
        warm = _launches()
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.fwd, capture_error_mode="thread_local"):
            outs = run(self.inputs)
        self.fwd_launches = _since(warm)
        mid = _launches()
        self.differentiable = tuple(o.requires_grad for o in outs)
        self.grad_outputs = tuple(torch.empty_like(o) if o.requires_grad else None
                                  for o in outs)
        with torch.cuda.graph(self.bwd, pool=self.fwd.pool(), capture_error_mode="thread_local"):
            grads = backward(outs, self.grad_outputs)
        self.bwd_launches = _since(mid)
        self.outputs = tuple(o.detach() for o in outs)
        self.param_grads = grads
        # a capture records launches and runs none; the warm-up's ran
        for k, n in zip(_cuda.KERNELS, warm):
            k.launches = n
        restore(model, saved)

    @staticmethod
    def _count(launches: Dict[_cuda.Kernel, int]) -> None:
        for k, n in launches.items():
            k.launches += n

    def replay_forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        for s, t in zip(self.inputs, inputs):
            if s.data_ptr() != t.data_ptr():
                s.copy_(t)
        self.fwd.replay()
        self._count(self.fwd_launches)
        # copies: a caller may keep a step's heads past the next replay
        return tuple(o.clone() for o in self.outputs)

    def replay_backward(self, grads) -> Tuple[Optional[torch.Tensor], ...]:
        for s, g in zip(self.grad_outputs, grads):
            if s is None:
                continue
            if g is None:
                s.zero_()
            elif s.data_ptr() != g.data_ptr():
                s.copy_(g)
        self.bwd.replay()
        self._count(self.bwd_launches)
        return tuple(None if g is None else g.detach() for g in self.param_grads)


class _Replay(torch.autograd.Function):
    """Autograd's node for a graph pair: the forward replays the forward
    graph; the backward copies the outputs' gradients in, replays the
    backward graph and hands autograd the parameters' gradients."""

    @staticmethod
    def forward(ctx, graphs: _Graphs, *args):
        ctx.graphs = graphs
        # autograd's device thread runs the backward: it records it in the
        # unit (the step) that ran the forward
        ctx.unit = trace.unit()
        ctx.set_materialize_grads(False)
        outs = graphs.replay_forward(args[:graphs.n_inputs])
        ctx.mark_non_differentiable(*(o for o, d in zip(outs, graphs.differentiable) if not d))
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        graphs = ctx.graphs
        with trace.span("backbone_graph_backward", unit=ctx.unit):
            trace.count("graph_replays")
            param_grads = graphs.replay_backward(grads)
        return (None,) * (1 + graphs.n_inputs) + param_grads


def backbone_heads(model: nn.Module, feats: torch.Tensor, hier: Hierarchy, momentum
                   ) -> Tuple[torch.Tensor, ...]:
    """``model.backbone_heads`` by replay where :func:`engaged`: (features,
    semantic log-probabilities, offsets, embeddings), differentiable to the
    model's parameters. A new input signature (:func:`cache_key`) captures
    first. Ends in one host read that waits for the forward graph, which
    the clustering's first read would wait for anyway, so that the phase
    holds its device work.

    The outputs are copies of the forward graph's static outputs; the
    parameters' gradients alias the backward graph's static buffers, which
    its next replay overwrites (the train step resets ``p.grad`` before
    each forward). Run one forward's backward before the next forward of
    the same signature."""
    inputs = graph_inputs(feats, momentum_tensor(momentum, feats.device), hier)
    params = [p for p in model.parameters() if p.requires_grad]
    cache = _CACHES.setdefault(model, collections.OrderedDict())
    key = cache_key(model, inputs)
    with trace.span("backbone_graph"):
        graphs = cache.get(key)
        if graphs is None:
            graphs = cache[key] = _Graphs(model, inputs, params)
            trace.count("graph_captures")
            while len(cache) > CACHE_SIZE:
                cache.popitem(last=False)
        cache.move_to_end(key)
        trace.count("graph_replays")
        outs = _Replay.apply(graphs, *inputs, *params)
        with trace.host_read("backbone_graph"):
            torch.cuda.current_stream(feats.device).synchronize()
    return outs
