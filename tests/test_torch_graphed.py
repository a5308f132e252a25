"""The BN momentum as a device tensor, and the parts of the backbone's CUDA
graphs (``models/graphed.py``) that run without a card: a 0-dim tensor
momentum gives the float's outputs, running statistics and gradients bit
for bit; the engagement rule (a CUDA training forward with grad, the sparse
UNet, no hooks) and its eager cases; the graphs' cache key; the snapshot
and restore of the buffers around the capture's warm-up; and the graphs'
inputs, which hold all that the backbone and heads read of a step. Tiny
plan, one synthetic tile in 4,096 rows, f32."""

import dataclasses

import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu_torch import _cuda
from panopticsegforlargescalepointcloud_tpu_torch.data import batch_arrays, collate_tiles
from panopticsegforlargescalepointcloud_tpu_torch.data.synthetic import synthetic_tile
from panopticsegforlargescalepointcloud_tpu_torch.models import graphed
from panopticsegforlargescalepointcloud_tpu_torch.models.norm import (
    MaskedBatchNorm, momentum_tensor)
from panopticsegforlargescalepointcloud_tpu_torch.models.pointgroup3heads import (
    PanopticConfig, PointGroup3HeadsNet)
from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import (
    build_hierarchy, default_capacities)
from panopticsegforlargescalepointcloud_tpu_torch.train import canonicalize
from panopticsegforlargescalepointcloud_tpu_torch.utils import trace

torch.set_num_threads(2)

CAPACITY = 4096
CFG = PanopticConfig(num_classes=9, stuff_classes=(0, 7, 8), backbone="tiny", feat_dim=4,
                     in_feat=8, num_samples=1, compute_dtype="float32")


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


def _same_bits(a, b):
    return torch.equal(_bits(a), _bits(b))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(4)
    vb = collate_tiles([synthetic_tile(rng, num_classes=9, stuff_classes=(0, 7, 8),
                                       n_instances=4, n_ground=1200, radius=5.0)],
                       capacity=CAPACITY, num_tiles=1)
    db = canonicalize(*batch_arrays(vb), device="cpu")
    return db, build_hierarchy(db.grid, CFG.num_down, device="cpu")


def _model(cfg=CFG, seed=0):
    torch.manual_seed(seed)
    model = PointGroup3HeadsNet(cfg)
    with torch.no_grad():  # statistics away from their initial 0 and 1
        for b in model.buffers():
            b.uniform_(0.5, 1.5)
    return model.train()


@pytest.mark.parametrize("momentum", [0.1, 0.02, 0.37])
def test_tensor_momentum_equals_the_float_bit_for_bit(momentum):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(300, 6, generator=gen) * 2.0 + 0.5
    mask = torch.rand(300, generator=gen) > 0.3
    x[~mask] = 0.0
    cot = torch.randn(300, 6, generator=gen)
    runs = []
    for mom in (momentum, torch.tensor(momentum, dtype=torch.float32)):
        torch.manual_seed(0)
        bn = MaskedBatchNorm(6).train()
        with torch.no_grad():
            bn.scale.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.2, 0.2)
            bn.mean.uniform_(-0.3, 0.3)
            bn.var.uniform_(0.5, 1.5)
        xt = x.clone().requires_grad_()
        y = bn(xt, mask, mom)
        (y * cot).sum().backward()
        runs.append((y, bn.mean, bn.var, xt.grad, bn.scale.grad, bn.bias.grad))
    for a, b in zip(*runs):
        assert _same_bits(a, b)


def test_momentum_tensor_uploads_a_float_once_and_passes_a_tensor():
    trace.drain()
    with trace.span("unit", on=True):
        t = momentum_tensor(0.1, "cpu")
        assert momentum_tensor(t, "cpu") is t
    recs = trace.drain()
    assert [r.name for r in recs if r.name.startswith("sync::")] == ["sync::bn_momentum"]
    assert t.dtype == torch.float32 and t.dim() == 0
    assert _same_bits(t, torch.as_tensor(0.1, dtype=torch.float32))


@pytest.mark.parametrize("case", ["engaged", "cpu", "eval", "no_grad", "kpconv", "pointnet2",
                                  "hook"])
def test_engagement_rule(case):
    cfg = dataclasses.replace(CFG, backbone=case) if case in ("kpconv", "pointnet2") else CFG
    model = _model(cfg)
    device = "cpu" if case == "cpu" else "cuda"
    if case == "eval":
        model.eval()
    if case == "hook":
        model.semantic_mlp.register_forward_hook(lambda *a: None)
    with torch.set_grad_enabled(case != "no_grad"):
        assert graphed.engaged(model, device) == (case == "engaged")
    # the CPU runs every case eagerly
    assert not graphed.engaged(model, "cpu")


@pytest.mark.parametrize("change", ["capacity", "input_dtype", "compute_dtype",
                                    "parameter", "buffer", "requires_grad"])
def test_cache_key_changes(change, batch):
    db, hier = batch
    model = _model()
    mom = torch.tensor(0.1)
    key = graphed.cache_key(model, graphed.graph_inputs(db.feats, mom, hier))
    assert key == graphed.cache_key(model, graphed.graph_inputs(db.feats.clone(), mom, hier))
    feats = db.feats
    if change == "capacity":
        caps = list(default_capacities(CAPACITY, CFG.num_down))
        caps[1] += 512
        hier = build_hierarchy(db.grid, CFG.num_down, capacities=tuple(caps), device="cpu")
    elif change == "input_dtype":
        feats = feats.double()
    elif change == "compute_dtype":
        model.cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    elif change == "parameter":
        p = next(model.backbone.parameters())
        p.data = p.data.clone()
    elif change == "buffer":
        b = next(model.backbone.buffers())
        b.data = b.data.clone()
    else:
        next(model.embed_out.parameters()).requires_grad_(False)
    assert graphed.cache_key(model, graphed.graph_inputs(feats, mom, hier)) != key


def test_snapshot_and_restore_leave_every_buffer_exact(batch):
    db, hier = batch
    model = _model()
    before = [b.clone() for b in model.buffers()]
    saved = graphed.snapshot(model)
    ptrs = [b.data_ptr() for b in model.buffers()]
    model.backbone_heads(db.feats, hier, torch.tensor(0.3), pos=db.pos)  # moves the statistics
    assert not all(torch.equal(a, b) for a, b in zip(before, model.buffers()))
    graphed.restore(model, saved)
    assert all(_same_bits(a, b) for a, b in zip(before, model.buffers()))
    assert ptrs == [b.data_ptr() for b in model.buffers()]


def test_graph_inputs_hold_all_the_backbone_reads(batch):
    """The backbone and heads on :func:`graphed.static_hierarchy` (maps and
    masks alone) give the full hierarchy's outputs, statistics and
    gradients bit for bit."""
    db, hier = batch
    mom = torch.tensor(0.1)
    inputs = graphed.graph_inputs(db.feats, mom, hier)
    assert len(inputs) == 2 + 4 * (CFG.num_down + 1) - 2
    runs = []
    for h in (hier, graphed.static_hierarchy(inputs)):
        model = _model()
        outs = model.backbone_heads(db.feats, h, mom, pos=None)[:4]
        sum((o * (i + 1)).sum() for i, o in enumerate(outs)).backward()
        runs.append(list(outs) + list(model.buffers()) + [p.grad for p in model.parameters()
                                                          if p.grad is not None])
    assert len(runs[0]) == len(runs[1])
    assert all(_same_bits(a, b) for a, b in zip(*runs))


def test_a_graph_replay_adds_the_launches_it_holds():
    """Each kernel wrapper is in the registry, so a replay can add the
    launches its capture recorded."""
    from panopticsegforlargescalepointcloud_tpu_torch.ops import conv

    assert {conv.KERNEL, conv.KERNEL_DX, conv.KERNEL_DW} <= set(_cuda.KERNELS)
    before = graphed._launches()
    conv.KERNEL_DW.launches += 3
    try:
        assert graphed._since(before) == {conv.KERNEL_DW: 3}
    finally:
        conv.KERNEL_DW.launches -= 3
