"""The point backbones: KPConv, rigid and deformable, and PointNet++
(counterpart of the JAX package's ``models/point_backbones.py``, the
reference's KPConvPaper and PointNet2_D feature extractors).

Both ride the voxel hierarchy: level l's points are the barycentres of
level l-1's (:func:`level_positions`), neighbourhoods come from the
grid-hash radius query (:func:`..cluster.neighbors.radius_query`, fixed K,
-1 padding), and upsampling follows the hierarchy's parent map (KPConv's
nearest upsample) or a 3-NN inverse-distance interpolation (PointNet++).

The kernel correlation of KPConv is two GEMMs: [Q, P, M] x [Q, M, C] per
query (a batched product), then [Q, P·C] x [P·C, D]. In bf16 the operands
are rounded to bf16 and the products accumulate in f32, as the JAX package
asks with ``preferred_element_type``: the first product's bf16 result is
the rounding the JAX package applies to it, the second is an f32 product
of bf16-valued operands. Dense layers compute in f32, as flax promotes
bf16 inputs against f32 weights.

The deformable layer's regularizers (fitting and repulsion, or
permissive) are returned by every block in training mode and summed per
name by the backbone: ``forward`` returns ``(features, losses)``, and the
losses are empty in eval mode. Module and parameter names mirror the flax
tree (``enc0_simple.KPConvLayer_0.kernel``, ``sa0.s0_mlp0``, ...), so that
:func:`..weights.params_from_flax` is a rename.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..cluster.neighbors import radius_query
from ..ops.hierarchy import Hierarchy
from ..ops.scatter import segment_mean
from .modules import _DTYPES
from .norm import MaskedBatchNorm

# reference KPConv constants (modules/KPConv/kernels.py:35, blocks.py:22-23)
INFLUENCE_TO_RADIUS = 1.5
RIGID_DENSITY = 2.5

Losses = Dict[str, torch.Tensor]


@functools.lru_cache(maxsize=8)
def kernel_dispositions(num_points: int = 15, seed: int = 42) -> np.ndarray:
    """Kernel points in the unit ball, point 0 at the origin: inverse-square
    repulsion and a spring to the origin, 400 gradient steps from a seeded
    uniform draw, scaled so the mean non-centre radius is 0.7. The JAX
    package's numpy code, so the array is the same bit for bit.
    [num_points, 3] float32, read-only (cached)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, size=(num_points, 3)).astype(np.float64)
    pts[0] = 0.0
    step = 0.01
    for _ in range(400):
        d = pts[:, None, :] - pts[None, :, :]
        dist = np.sqrt(np.sum(d * d, axis=-1)) + 1e-9
        np.fill_diagonal(dist, np.inf)
        force = np.sum(d / (dist**3)[:, :, None], axis=1) - 2.0 * pts
        force[0] = 0.0
        norm = np.sqrt(np.sum(force * force, axis=-1, keepdims=True)) + 1e-9
        pts = pts + step * force / np.maximum(norm, 1.0)
        r = np.sqrt(np.sum(pts * pts, axis=-1, keepdims=True))
        pts = np.where(r > 1.0, pts / np.maximum(r, 1e-9), pts)
    r = np.sqrt(np.sum(pts[1:] ** 2, axis=-1))
    pts[1:] *= 0.7 / max(float(r.mean()), 1e-9)
    out = pts.astype(np.float32)
    out.setflags(write=False)
    return out


def level_positions(pos: torch.Tensor, hier: Hierarchy
                    ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Per-level positions and valid masks: level 0 is ``pos``, level l+1
    the masked mean of its children through the parent map (the cell
    barycentres)."""
    ps = [pos]
    masks = [hier.grids[0].mask]
    for lvl, parent in enumerate(hier.parents):
        seg = torch.where(hier.grids[lvl].mask & (parent >= 0), parent,
                          torch.full_like(parent, -1))
        ps.append(segment_mean(ps[lvl], seg, hier.grids[lvl + 1].capacity))
        masks.append(hier.grids[lvl + 1].mask)
    return tuple(ps), tuple(masks)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for non-negative ``idx`` of any shape, by ``index_select``:
    its backward is one ``index_add_``, where advanced indexing's sorts the
    indices first."""
    return x.index_select(0, idx.reshape(-1)).reshape(idx.shape + x.shape[1:])


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_c (a[..., c] - b[..., c])², summed in coordinate order without a
    [..., 3] difference tensor."""
    out = None
    for c in range(3):
        d = a[..., c] - b[..., c]
        out = d * d if out is None else out + d * d
    return out


def _correlate(infl: torch.Tensor, nf: torch.Tensor, weights: torch.Tensor,
               cdt: torch.dtype) -> torch.Tensor:
    """[Q, M, P] influences x [Q, M, C] neighbour features -> [Q, P, C]
    (rounded to ``cdt``), then x [P, C, D] weights -> [Q, D] f32."""
    wf = torch.bmm(infl.to(cdt).transpose(1, 2), nf.to(cdt))
    q, p, c = wf.shape
    return wf.reshape(q, p * c).float() @ weights.to(cdt).float().reshape(p * c, -1)


class _KPBase(nn.Module):
    """Neighbour gather and kernel-point geometry shared by both layers.
    The kernel points (``INFLUENCE_TO_RADIUS · extent`` times the unit
    dispositions) are a constant, not state: no buffer, one copy per
    device."""

    def __init__(self, extent: float, num_kernel_points: int, compute_dtype: str):
        super().__init__()
        self.extent = extent
        self.num_kernel_points = num_kernel_points
        self.compute_dtype = _DTYPES[compute_dtype]
        kp = kernel_dispositions(num_kernel_points) * (INFLUENCE_TO_RADIUS * extent)
        self._kernel_points = {torch.device("cpu"): torch.from_numpy(kp)}

    def kernel_points(self, device: torch.device) -> torch.Tensor:
        """[P, 3] f32 on ``device``."""
        if device not in self._kernel_points:
            self._kernel_points[device] = self._kernel_points[torch.device("cpu")].to(device)
        return self._kernel_points[device]

    def _neighbours(self, q_pos, s_pos, s_feats, nbr_idx):
        """(valid [Q, M], relative positions [Q, M, 3], masked features)."""
        ok = nbr_idx >= 0
        idx = nbr_idx.clamp(min=0).long()
        rel = _rows(s_pos, idx) - q_pos[:, None, :]
        nf = _rows(s_feats, idx) * ok[:, :, None].to(s_feats.dtype)
        return ok, rel, nf

    def _influence(self, sq: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
        """Linear influence max(0, 1 - d / extent) of squared distances,
        zero at invalid neighbours."""
        d = torch.sqrt(torch.clamp(sq, min=1e-12))
        return torch.relu(1.0 - d / self.extent) * ok[:, :, None]


class KPConvLayer(_KPBase):
    """Rigid kernel-point convolution; weights ``kernel`` [P, Cin, Cout]."""

    def __init__(self, cin: int, features: int, extent: float, num_kernel_points: int = 15,
                 compute_dtype: str = "float32"):
        super().__init__(extent, num_kernel_points, compute_dtype)
        self.kernel = nn.Parameter(torch.zeros(num_kernel_points, cin, features))

    def forward(self, q_pos, s_pos, s_feats, nbr_idx) -> torch.Tensor:
        ok, rel, nf = self._neighbours(q_pos, s_pos, s_feats, nbr_idx)
        kp = self.kernel_points(q_pos.device)
        infl = self._influence(_sq_dist(rel[:, :, None, :], kp[None, None]), ok)
        return _correlate(infl, nf, self.kernel, self.compute_dtype)


class KPConvDeformableLayer(_KPBase):
    """Deformable kernel-point convolution: a rigid pass with its own
    ``offset_kernel`` [P, Cin, 3P (4P modulated)] and ``offset_bias``
    predicts per-query kernel-point offsets (times ``extent``; modulated:
    also a gain 2·sigmoid per point), then the main ``kernel`` correlates
    against the deformed points. In training mode it also returns its
    regularizers, masked to valid queries: ``fitting`` (the mean min
    squared neighbour distance per kernel point over radius²) and
    ``repulsion`` (relu(1.5 - d)² between deformed points in units of
    ``extent``, the other side detached), or ``permissive`` (the mean
    norm of the points outside the radius, in radii)."""

    def __init__(self, cin: int, features: int, extent: float, num_kernel_points: int = 15,
                 modulated: bool = False, loss_mode: str = "fitting",
                 compute_dtype: str = "float32"):
        super().__init__(extent, num_kernel_points, compute_dtype)
        p = num_kernel_points
        self.modulated = modulated
        self.loss_mode = loss_mode
        off_dim = (4 if modulated else 3) * p
        self.offset_kernel = nn.Parameter(torch.zeros(p, cin, off_dim))
        self.offset_bias = nn.Parameter(torch.zeros(off_dim))
        self.kernel = nn.Parameter(torch.zeros(p, cin, features))

    def forward(self, q_pos, s_pos, s_feats, nbr_idx, q_mask) -> Tuple[torch.Tensor, Losses]:
        p = self.num_kernel_points
        cdt = self.compute_dtype
        kp = self.kernel_points(q_pos.device)
        ok, rel, nf = self._neighbours(q_pos, s_pos, s_feats, nbr_idx)
        rel4 = rel[:, :, None, :]
        infl_rigid = self._influence(_sq_dist(rel4, kp[None, None]), ok)
        off_feat = _correlate(infl_rigid, nf, self.offset_kernel, cdt) + self.offset_bias
        deformed = kp[None] + off_feat[:, :3 * p].reshape(-1, p, 3) * self.extent  # [Q, P, 3]
        sq = _sq_dist(rel4, deformed[:, None])  # [Q, M, P]
        infl = self._influence(sq, ok)
        if self.modulated:
            infl = infl * (2.0 * torch.sigmoid(off_feat[:, 3 * p:]))[:, None, :]
        out = _correlate(infl, nf, self.kernel, cdt)
        if not self.training:
            return out, {}
        return out, self._regularizers(deformed, sq, ok, q_mask)

    def _regularizers(self, deformed, sq, ok, q_mask) -> Losses:
        p = self.num_kernel_points
        radius = INFLUENCE_TO_RADIUS * self.extent
        if self.loss_mode == "permissive":
            norm = torch.sqrt(torch.clamp((deformed * deformed).sum(dim=-1), min=1e-12))
            outside = (norm > radius) & q_mask[:, None]
            cnt = torch.clamp(outside.float().sum(), min=1.0)
            perm = torch.where(outside, norm / radius, torch.zeros_like(norm)).sum() / cnt
            return {"permissive": perm}
        kpmin = torch.amin(torch.where(ok[:, :, None], sq, torch.full_like(sq, 1e9)), dim=1)
        has = ok.any(dim=1, keepdim=True) & q_mask[:, None]
        fit = torch.where(has, kpmin, torch.zeros_like(kpmin)).sum() / (
            torch.clamp(has.float().sum() * p, min=1.0) * radius**2)
        dk = deformed / self.extent
        pd = torch.sqrt(torch.clamp(_sq_dist(dk[:, :, None, :], dk.detach()[:, None]),
                                    min=1e-12))  # [Q, P, P]
        off_diag = ~torch.eye(p, dtype=torch.bool, device=dk.device)
        rep = torch.relu(1.5 - pd) ** 2 * off_diag[None]
        qm = q_mask.float()
        rep = (rep.sum(dim=(1, 2)) * qm).sum() / torch.clamp(qm.sum(), min=1.0)
        return {"fitting": fit, "repulsion": rep}


def _add(total: Losses, more: Losses) -> Losses:
    for k, v in more.items():
        total[k] = total[k] + v if k in total else v
    return total


class KPSimpleBlock(nn.Module):
    """KPConv (deformable or rigid) -> masked BN -> LeakyReLU(0.1)."""

    def __init__(self, cin: int, features: int, extent: float, num_kernel_points: int = 15,
                 deformable: bool = False, modulated: bool = False, loss_mode: str = "fitting",
                 compute_dtype: str = "float32"):
        super().__init__()
        self.deformable = deformable
        if deformable:
            self.KPConvDeformableLayer_0 = KPConvDeformableLayer(
                cin, features, extent, num_kernel_points, modulated, loss_mode, compute_dtype)
        else:
            self.KPConvLayer_0 = KPConvLayer(cin, features, extent, num_kernel_points,
                                             compute_dtype)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features)

    def forward(self, q_pos, s_pos, s_feats, nbr_idx, q_mask, momentum=0.1
                ) -> Tuple[torch.Tensor, Losses]:
        if self.deformable:
            h, losses = self.KPConvDeformableLayer_0(q_pos, s_pos, s_feats, nbr_idx, q_mask)
        else:
            h, losses = self.KPConvLayer_0(q_pos, s_pos, s_feats, nbr_idx), {}
        return F.leaky_relu(self.MaskedBatchNorm_0(h, q_mask, momentum), 0.1), losses


class KPResnetBBlock(nn.Module):
    """Bottleneck: unary(C/4) -> KPConv(C/4) -> unary(C), plus the shortcut
    (identity, or unary + BN where the width changes; strided: first a
    max-pool of the input over the coarse query's neighbours). No
    activation after the residual add, as in the reference's forward."""

    def __init__(self, cin: int, features: int, extent: float, strided: bool = False,
                 num_kernel_points: int = 15, deformable: bool = False, modulated: bool = False,
                 loss_mode: str = "fitting", compute_dtype: str = "float32"):
        super().__init__()
        d2 = features // 4
        self.strided = strided
        self.Dense_0 = nn.Linear(cin, d2, bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(d2)
        self.KPSimpleBlock_0 = KPSimpleBlock(d2, d2, extent, num_kernel_points, deformable,
                                             modulated, loss_mode, compute_dtype)
        self.Dense_1 = nn.Linear(d2, features, bias=False)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(features)
        if cin != features:
            self.Dense_2 = nn.Linear(cin, features, bias=False)
            self.MaskedBatchNorm_2 = MaskedBatchNorm(features)

    def forward(self, q_pos, s_pos, s_feats, nbr_idx, q_mask, s_mask, momentum=0.1
                ) -> Tuple[torch.Tensor, Losses]:
        h = F.leaky_relu(self.MaskedBatchNorm_0(self.Dense_0(s_feats), s_mask, momentum), 0.1)
        h, losses = self.KPSimpleBlock_0(q_pos, s_pos, h, nbr_idx, q_mask, momentum)
        h = F.leaky_relu(self.MaskedBatchNorm_1(self.Dense_1(h), q_mask, momentum), 0.1)
        if self.strided:
            ok = nbr_idx >= 0
            g = _rows(s_feats, nbr_idx.clamp(min=0).long())
            g = torch.where(ok[:, :, None], g, torch.full_like(g, float("-inf")))
            sc = torch.amax(g, dim=1)
            sc = torch.where(ok.any(dim=1)[:, None], sc, torch.zeros_like(sc))
        else:
            sc = s_feats
        if hasattr(self, "Dense_2"):
            sc = self.MaskedBatchNorm_2(self.Dense_2(sc), q_mask, momentum)
        return h + sc, losses


class KPConvBackbone(nn.Module):
    """KPConv UNet over the voxel hierarchy (reference KPConvPaper). Encoder:
    level 0 a rigid SimpleBlock and a ResnetB; each deeper level a strided
    ResnetB (coarse queries against fine support) and a ResnetB; channels
    double per level. Decoder: parent-map nearest upsample, skip concat,
    unary + BN + LeakyReLU(0.1) per level. Level l's cell is ``grid_size ·
    2^l``, its extent ``sigma`` cells and its search radius
    ``RIGID_DENSITY · sigma`` cells. ``deformable`` deforms every encoder
    block past the stem."""

    def __init__(self, in_channels: int, num_levels: int = 4, base_channels: int = 64,
                 out_nc: int = 16, grid_size: float = 0.2, sigma: float = 1.0,
                 num_kernel_points: int = 15, max_neighbors: int = 16, cell_cap: int = 16,
                 deformable: bool = False, modulated: bool = False, loss_mode: str = "fitting",
                 compute_dtype: str = "float32"):
        super().__init__()
        self.num_levels = num_levels
        self.grid_size, self.sigma = grid_size, sigma
        self.max_neighbors, self.cell_cap = max_neighbors, cell_cap
        kw = dict(num_kernel_points=num_kernel_points, compute_dtype=compute_dtype)
        dkw = dict(deformable=deformable, modulated=modulated, loss_mode=loss_mode, **kw)
        c0 = base_channels
        ext0 = sigma * grid_size
        self.enc0_simple = KPSimpleBlock(in_channels, c0, ext0, **kw)
        self.enc0_resb = KPResnetBBlock(c0, c0 * 2, ext0, **dkw)
        ch = c0 * 2
        skip_ch = [ch]
        for lvl in range(num_levels):
            ext = sigma * grid_size * (2.0 ** (lvl + 1))
            setattr(self, f"enc{lvl + 1}_strided",
                    KPResnetBBlock(ch, ch * 2, ext / 2.0, strided=True, **dkw))
            setattr(self, f"enc{lvl + 1}_resb", KPResnetBBlock(ch * 2, ch * 2, ext, **dkw))
            ch *= 2
            skip_ch.append(ch)
        for i, lvl in enumerate(range(num_levels - 1, -1, -1)):
            cin = ch + skip_ch[lvl]
            ch = max(ch // 2, out_nc)
            c_out = ch if lvl > 0 else out_nc
            setattr(self, f"dec{lvl}_unary", nn.Linear(cin, c_out, bias=False))
            setattr(self, f"MaskedBatchNorm_{i}", MaskedBatchNorm(c_out))

    def radius(self, lvl: int) -> float:
        """The neighbour search radius of level ``lvl``'s convolutions."""
        return RIGID_DENSITY * self.sigma * self.grid_size * (2.0 ** lvl)

    def forward(self, feats, pos, hier: Hierarchy, momentum=0.1
                ) -> Tuple[torch.Tensor, Losses]:
        if len(hier.parents) < self.num_levels:
            raise ValueError(f"hierarchy has {len(hier.parents)} strided levels, "
                             f"KPConvBackbone needs {self.num_levels}")
        ps, masks = level_positions(pos, hier)
        batches = [g.batch for g in hier.grids]

        def nbrs(q, s):  # queries at level q against support at level s (radius of s)
            return radius_query(ps[q], batches[q], masks[q], ps[s], batches[s], masks[s],
                                radius=self.radius(s), k=self.max_neighbors,
                                cell_cap=self.cell_cap)[0]

        losses: Losses = {}
        nbr0 = nbrs(0, 0)
        x, _ = self.enc0_simple(ps[0], ps[0], feats, nbr0, masks[0], momentum)
        x, more = self.enc0_resb(ps[0], ps[0], x, nbr0, masks[0], masks[0], momentum)
        _add(losses, more)
        skips = [x]
        for lvl in range(self.num_levels):
            x, more = getattr(self, f"enc{lvl + 1}_strided")(
                ps[lvl + 1], ps[lvl], x, nbrs(lvl + 1, lvl), masks[lvl + 1], masks[lvl],
                momentum)
            _add(losses, more)
            x, more = getattr(self, f"enc{lvl + 1}_resb")(
                ps[lvl + 1], ps[lvl + 1], x, nbrs(lvl + 1, lvl + 1), masks[lvl + 1],
                masks[lvl + 1], momentum)
            _add(losses, more)
            if lvl < self.num_levels - 1:
                skips.append(x)
        for i, lvl in enumerate(range(self.num_levels - 1, -1, -1)):
            parent = hier.parents[lvl]
            up = _rows(x, parent.clamp(min=0).long())
            up = torch.where((parent >= 0)[:, None], up, torch.zeros_like(up))
            x = getattr(self, f"dec{lvl}_unary")(torch.cat([up, skips[lvl]], dim=-1))
            x = F.leaky_relu(getattr(self, f"MaskedBatchNorm_{i}")(x, masks[lvl], momentum), 0.1)
        return x * masks[0][:, None].to(x.dtype), losses


class PointNet2SAModule(nn.Module):
    """Multi-scale-grouping set abstraction: per scale, a radius query of
    the support, the group's features with the centred xyz first (rounded
    to ``compute_dtype``), a shared MLP (Dense -> masked BN over the valid
    group entries -> ReLU), a masked max-pool; the scales concatenate."""

    def __init__(self, cin: int, radii: Sequence[float], nsamples: Sequence[int],
                 mlps: Sequence[Sequence[int]], use_xyz: bool = True, cell_cap: int = 16,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.radii, self.nsamples = tuple(radii), tuple(nsamples)
        self.mlps = tuple(tuple(m) for m in mlps)
        self.use_xyz, self.cell_cap = use_xyz, cell_cap
        self.compute_dtype = _DTYPES[compute_dtype]
        for i, mlp in enumerate(self.mlps):
            c = cin + (3 if use_xyz else 0)
            for j, co in enumerate(mlp):
                setattr(self, f"s{i}_mlp{j}", nn.Linear(c, co, bias=False))
                setattr(self, f"s{i}_bn{j}", MaskedBatchNorm(co))
                c = co

    def forward(self, q_pos, q_batch, q_mask, s_pos, s_batch, s_mask, s_feats, momentum=0.1):
        outs = []
        for i, (r, ns, mlp) in enumerate(zip(self.radii, self.nsamples, self.mlps)):
            idx, _ = radius_query(q_pos, q_batch, q_mask, s_pos, s_batch, s_mask, radius=r,
                                  k=ns, cell_cap=self.cell_cap)
            ok = idx >= 0
            ii = idx.clamp(min=0).long()
            g = _rows(s_feats, ii)  # [Q, M, C]
            if self.use_xyz:
                g = torch.cat([(_rows(s_pos, ii) - q_pos[:, None, :]).to(g.dtype), g], dim=-1)
            h = g.to(self.compute_dtype).float()
            flat_ok = ok.reshape(-1)
            for j in range(len(mlp)):
                h = getattr(self, f"s{i}_mlp{j}")(h)
                flat = getattr(self, f"s{i}_bn{j}")(h.reshape(-1, h.shape[-1]), flat_ok,
                                                     momentum)
                h = torch.relu(flat.reshape(h.shape))
            h = torch.where(ok[:, :, None], h, torch.full_like(h, float("-inf")))
            pooled = torch.amax(h, dim=1)
            pooled = torch.where(ok.any(dim=1)[:, None], pooled, torch.zeros_like(pooled))
            outs.append(pooled.float())
        return torch.cat(outs, dim=-1) * q_mask[:, None]


class PointNet2FPModule(nn.Module):
    """Feature propagation: 3-NN inverse-squared-distance interpolation of
    the coarse features onto the fine points (the hierarchy parent where
    the bounded search found nothing), the fine skip concatenated, then
    Dense -> masked BN -> ReLU layers."""

    def __init__(self, cin: int, mlp: Sequence[int], radius: float, cell_cap: int = 16):
        super().__init__()
        self.mlp = tuple(mlp)
        self.radius, self.cell_cap = radius, cell_cap
        for j, co in enumerate(self.mlp):
            setattr(self, f"mlp{j}", nn.Linear(cin, co, bias=False))
            setattr(self, f"bn{j}", MaskedBatchNorm(co))
            cin = co

    def forward(self, f_pos, f_batch, f_mask, f_skip, c_pos, c_batch, c_mask, c_feats,
                parent, momentum=0.1):
        idx, d2 = radius_query(f_pos, f_batch, f_mask, c_pos, c_batch, c_mask,
                               radius=self.radius, k=3, cell_cap=self.cell_cap)
        no_hit = ~(idx >= 0).any(dim=1)
        fb = torch.where(no_hit & (parent >= 0), parent, idx[:, 0])
        pd2 = _sq_dist(_rows(c_pos, fb.clamp(min=0).long()), f_pos)
        idx = torch.cat([fb[:, None], idx[:, 1:]], dim=1)
        d2 = torch.cat([torch.where(no_hit, pd2, d2[:, 0])[:, None], d2[:, 1:]], dim=1)
        ok = idx >= 0
        w = torch.where(ok, 1.0 / torch.clamp(d2, min=1e-10), torch.zeros_like(d2))
        w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-10)
        g = _rows(c_feats, idx.clamp(min=0).long())  # [F, 3, C]
        h = torch.cat([(g * w[:, :, None].to(g.dtype)).sum(dim=1), f_skip], dim=-1)
        for j in range(len(self.mlp)):
            h = getattr(self, f"mlp{j}")(h)
            h = torch.relu(getattr(self, f"bn{j}")(h, f_mask, momentum))
        return h * f_mask[:, None].to(h.dtype)


class PointNet2Backbone(nn.Module):
    """PointNet++ MSG UNet over the voxel hierarchy (reference PointNet2_D):
    per level a set abstraction with grouping radii ``radius_scale`` and
    twice that, in cells of the finer level, then feature propagation back
    up with the 3-NN interpolation."""

    def __init__(self, in_channels: int, num_levels: int = 3, base_channels: int = 32,
                 out_nc: int = 16, grid_size: float = 0.2, radius_scale: float = 2.5,
                 nsample: int = 16, cell_cap: int = 16, compute_dtype: str = "float32"):
        super().__init__()
        self.num_levels = num_levels
        ch = base_channels
        cin = in_channels
        skip_ch = [in_channels]
        for lvl in range(num_levels):
            r0 = radius_scale * grid_size * (2.0 ** lvl)
            setattr(self, f"sa{lvl}", PointNet2SAModule(
                cin, radii=(r0, 2.0 * r0), nsamples=(nsample, nsample),
                mlps=((ch, ch), (ch, ch)), cell_cap=cell_cap, compute_dtype=compute_dtype))
            cin = 2 * ch
            ch *= 2
            skip_ch.append(cin)
        for lvl in range(num_levels - 1, -1, -1):
            c_out = max(ch // 2, out_nc) if lvl > 0 else out_nc
            setattr(self, f"fp{lvl}", PointNet2FPModule(
                cin + skip_ch[lvl], (c_out, c_out),
                radius=radius_scale * grid_size * (2.0 ** (lvl + 1)), cell_cap=cell_cap))
            cin = ch = c_out

    def forward(self, feats, pos, hier: Hierarchy, momentum=0.1
                ) -> Tuple[torch.Tensor, Losses]:
        if len(hier.parents) < self.num_levels:
            raise ValueError(f"hierarchy has {len(hier.parents)} strided levels, "
                             f"PointNet2Backbone needs {self.num_levels}")
        ps, masks = level_positions(pos, hier)
        batches = [g.batch for g in hier.grids]
        x = feats
        skips = [x]
        for lvl in range(self.num_levels):
            x = getattr(self, f"sa{lvl}")(ps[lvl + 1], batches[lvl + 1], masks[lvl + 1],
                                          ps[lvl], batches[lvl], masks[lvl], x, momentum)
            if lvl < self.num_levels - 1:
                skips.append(x)
        for lvl in range(self.num_levels - 1, -1, -1):
            x = getattr(self, f"fp{lvl}")(ps[lvl], batches[lvl], masks[lvl], skips[lvl],
                                          ps[lvl + 1], batches[lvl + 1], masks[lvl + 1], x,
                                          hier.parents[lvl], momentum)
        return x, {}
