"""Carry weights from the JAX package's flax trees into the port's model.

The port's module names mirror the flax names, so the map is a rename:
``backbone/down_0/ConvBNReLU_0/SparseConv_0/kernel`` becomes
``backbone.down_0.ConvBNReLU_0.SparseConv_0.kernel``. Two kinds of leaf
change form: a 2-D ``kernel`` (``nn.Dense``: heads, MLPs, 1x1 shortcuts,
also where it is applied to [Q, M, C] groups) is stored [in, out] by flax
and becomes the transposed ``weight`` of an ``nn.Linear``; a 3-D ``kernel``
([27, Cin, Cout] sparse conv, [P, Cin, Cout] KPConv) stays as is, as do the
deformable KPConv's ``offset_kernel`` and ``offset_bias``.
``batch_stats`` ``mean``/``var`` become the MaskedBatchNorm buffers.
:func:`flax_paths` is the inverse, for a state_dict or for gradients.

:func:`params_from_reference` carries a reference torch-points3d
``PointGroup3heads`` state dict (MinkowskiEngine convs) into the same
state_dict, by the rules of the repo's ``tools/import_torch_checkpoint.py``
(numpy only, no JAX): ME's x-fastest kernel order is permuted into the
port's z-fastest one (:func:`me_to_ours_perm`), every 3x3x3 conv of an up
module has its K axis reversed (the transpose map indexes by the negated
offset), a 1x1 shortcut ``[Cin, Cout]`` or ``[1, Cin, Cout]`` stays as is,
``Linear`` weights ``[out, in]`` stay as is, and both BN spellings (``bn.``,
``batch_norm.``) are read. Keys it does not read (``num_batches_tracked``)
are ignored.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .ops.sparse import _kernel_offsets

# parameter leaves that keep their flax form
_LEAVES = ("kernel", "bias", "scale", "offset_kernel", "offset_bias")


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, v


def params_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays (flax ``params`` and ``batch_stats``) ->
    the port model's ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        name = path[-1]
        if name == "kernel" and arr.ndim == 2:
            arr, name = arr.T, "weight"
        elif name not in _LEAVES:
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
        sd[".".join(path[:-1] + (name,))] = torch.from_numpy(np.array(arr, order="C", copy=True))
    for path, leaf in _flatten(batch_stats):
        if path[-1] not in ("mean", "var"):
            raise KeyError(f"unexpected flax batch stat {'/'.join(path)}")
        sd[".".join(path)] = torch.from_numpy(np.array(leaf, dtype=np.float32, copy=True))
    return sd


def flax_paths(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_flax` for any name -> tensor map (a
    ``state_dict``, or ``{name: p.grad}``): flax paths joined by ``/``
    (``backbone/down_0/.../kernel``) -> f32 numpy arrays, with ``nn.Linear``
    weights transposed back into flax ``kernel``s. BN buffers keep their
    ``mean``/``var`` leaf names (the flax ``batch_stats`` paths)."""
    out: Dict[str, np.ndarray] = {}
    for name, t in tensors.items():
        path = name.split(".")
        arr = t.detach().float().cpu().numpy()
        if path[-1] == "weight":
            if arr.ndim != 2:
                raise KeyError(f"unexpected weight {name} of shape {arr.shape}")
            arr, path[-1] = arr.T, "kernel"
        elif path[-1] not in _LEAVES + ("mean", "var"):
            raise KeyError(f"unexpected tensor {name}")
        out["/".join(path)] = np.ascontiguousarray(arr)
    return out


def me_kernel_offsets(kernel_size: int = 3, dimension: int = 3) -> np.ndarray:
    """MinkowskiEngine's HYPER_CUBE kernel-region offsets, [K, dimension]
    int32: the first axis fastest, per axis -(k-1)//2..k//2 for odd k and
    0..k-1 for even k."""
    rng = (np.arange(-(kernel_size // 2), kernel_size // 2 + 1) if kernel_size % 2 == 1
           else np.arange(0, kernel_size))
    j = np.arange(kernel_size ** dimension)
    cols = [rng[(j // kernel_size ** a) % kernel_size] for a in range(dimension)]
    return np.stack(cols, axis=1).astype(np.int32)


def me_to_ours_perm(kernel_size: int = 3) -> np.ndarray:
    """K permutation p with ``W_ours = W_me[p]``: p[k] is the ME kernel index
    whose offset is the port's z-fastest offset k (``ops/sparse.py``)."""
    lut = {tuple(o): j for j, o in enumerate(me_kernel_offsets(kernel_size))}
    return np.array([lut[tuple(o)] for o in _kernel_offsets(kernel_size)], dtype=np.int64)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bn(sd: Mapping, prefix: str) -> Tuple[Dict, Dict]:
    """A torch BN under ``prefix`` (``.bn``, ``.batch_norm`` or bare) ->
    (params {scale, bias}, stats {mean, var})."""
    for stem in (prefix + ".bn", prefix + ".batch_norm", prefix):
        if stem + ".weight" in sd:
            return ({"scale": _np(sd[stem + ".weight"]), "bias": _np(sd[stem + ".bias"])},
                    {"mean": _np(sd[stem + ".running_mean"]),
                     "var": _np(sd[stem + ".running_var"])})
    raise KeyError(f"no BN under {prefix}")


def _kernel(sd: Mapping, key: str, offset_perm, reverse: bool) -> Dict:
    w = _np(sd[key])
    if w.ndim != 3:
        raise ValueError(f"{key}: expected an ME kernel [K, Cin, Cout], got {w.shape}")
    if offset_perm is not None:
        w = w[offset_perm]
    return {"kernel": w[::-1] if reverse else w}


def _linear(sd: Mapping, prefix: str, bias: bool = True) -> Dict:
    out = {"kernel": _np(sd[prefix + ".weight"]).T}
    if bias and prefix + ".bias" in sd:
        out["bias"] = _np(sd[prefix + ".bias"])
    return out


def _resnet(sd: Mapping, prefix: str, num_blocks: int, offset_perm, reverse: bool):
    """A reference ResNetDown/ResNetUp (conv_in, then ResBlocks with an
    optional 1x1 ``downsample``) -> the port's flax-named subtree."""
    params = {"ConvBNReLU_0": {"SparseConv_0": _kernel(sd, f"{prefix}.conv_in.0.kernel",
                                                       offset_perm, reverse)}}
    bn_p, bn_s = _bn(sd, f"{prefix}.conv_in.1")
    params["ConvBNReLU_0"]["MaskedBatchNorm_0"] = bn_p
    stats = {"ConvBNReLU_0": {"MaskedBatchNorm_0": bn_s}}
    for b in range(num_blocks):
        bp, bs = {}, {}
        for j, conv_idx, bn_idx in ((0, 0, 1), (1, 3, 4)):
            bp[f"ConvBNReLU_{j}"] = {"SparseConv_0": _kernel(
                sd, f"{prefix}.blocks.{b}.block.{conv_idx}.kernel", offset_perm, reverse)}
            p2, s2 = _bn(sd, f"{prefix}.blocks.{b}.block.{bn_idx}")
            bp[f"ConvBNReLU_{j}"]["MaskedBatchNorm_0"] = p2
            bs[f"ConvBNReLU_{j}"] = {"MaskedBatchNorm_0": s2}
        ds_key = f"{prefix}.blocks.{b}.downsample.0.kernel"
        if ds_key in sd:
            w = _np(sd[ds_key])
            bp["Dense_0"] = {"kernel": w[0] if w.ndim == 3 else w}
            bp["MaskedBatchNorm_0"], bs["MaskedBatchNorm_0"] = _bn(
                sd, f"{prefix}.blocks.{b}.downsample.1")
        params[f"ResBlock_{b}"], stats[f"ResBlock_{b}"] = bp, bs
    return params, stats


def params_from_reference(sd: Mapping[str, Any], num_down_blocks: int = 7,
                          num_up_blocks: int = 7, n_res: int = 2, scorer_downs: int = 2,
                          scorer_ups: int = 2, scorer_n_res: int = 2, offset_perm=None
                          ) -> Dict[str, torch.Tensor]:
    """A reference ``PointGroup3heads`` state dict (tensors or arrays) -> the
    port model's ``state_dict``. The defaults are the paper plan
    (``models/plans.py``); ``offset_perm`` is the K permutation applied to
    every 3x3x3 kernel (``me_to_ours_perm(3)`` for ME's own order, None to
    keep the order as stored)."""
    params: Dict[str, Any] = {"backbone": {}, "scorer": {}}
    stats: Dict[str, Any] = {"backbone": {}, "scorer": {}}
    for ours, theirs, downs, ups, blocks in (
            ("backbone", "Backbone", num_down_blocks, num_up_blocks, n_res),
            ("scorer", "ScorerUnet", scorer_downs, scorer_ups, scorer_n_res)):
        for i in range(downs):
            params[ours][f"down_{i}"], stats[ours][f"down_{i}"] = _resnet(
                sd, f"{theirs}.model.down_modules.{i}", blocks, offset_perm, False)
        for i in range(ups):
            p, s = _resnet(sd, f"{theirs}.model.up_modules.{i}", blocks, offset_perm, True)
            params[ours][f"up_{i}"], stats[ours][f"up_{i}"] = {"up": p}, {"up": s}
    for ours, theirs in (("semantic", "Semantic"), ("offset", "Offset"), ("embed", "Embed")):
        params[f"{ours}_mlp"] = {"Dense_0": _linear(sd, f"{theirs}.0.0.0", bias=False)}
        bn_p, bn_s = _bn(sd, f"{theirs}.0.0.1")
        params[f"{ours}_mlp"]["MaskedBatchNorm_0"] = bn_p
        stats[f"{ours}_mlp"] = {"MaskedBatchNorm_0": bn_s}
        params[f"{ours}_out"] = _linear(sd, f"{theirs}.1")
    params["scorer_head"] = _linear(sd, "ScorerHead.0")
    return params_from_flax(params, stats)


_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_HEADS = {f"{ours}_{part}": (theirs, part) for ours, theirs in (
    ("semantic", "Semantic"), ("offset", "Offset"), ("embed", "Embed")) for part in ("mlp", "out")}


def _reference_resnet_key(path) -> Tuple[str, str]:
    """(reference key stem, leaf kind) of a ResNetDown/Up leaf path below
    the module (``ConvBNReLU_0/SparseConv_0/kernel`` -> ``conv_in.0``)."""
    if path[0] == "ConvBNReLU_0":
        return ("conv_in.0", "conv") if path[1] == "SparseConv_0" else ("conv_in.1", "bn")
    block = f"blocks.{path[0].split('_')[1]}"
    if path[1] == "Dense_0":
        return f"{block}.downsample.0", "shortcut"
    if path[1] == "MaskedBatchNorm_0":
        return f"{block}.downsample.1", "bn"
    conv, bn = (0, 1) if path[1] == "ConvBNReLU_0" else (3, 4)
    return (f"{block}.block.{conv}", "conv") if path[2] == "SparseConv_0" else (
        f"{block}.block.{bn}", "bn")


def reference_from_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`params_from_reference` with ``offset_perm =
    me_to_ours_perm(3)``: the port model's ``state_dict`` -> a reference
    torch-points3d state dict (ME kernel order, the up modules' kernels with
    K reversed, ``Linear`` weights ``[out, in]``, ``.bn.`` BN spellings and a
    ``num_batches_tracked`` per BN). Defined for the layout the reference
    and :func:`params_from_reference` share (UNet ScoreNet, three heads);
    another tensor raises KeyError."""
    inv = np.argsort(me_to_ours_perm(3))
    sd: Dict[str, torch.Tensor] = {}
    for name, arr in flax_paths(state_dict).items():
        path = name.split("/")
        leaf = path[-1]
        if path[0] in ("backbone", "scorer"):
            net = "Backbone" if path[0] == "backbone" else "ScorerUnet"
            kind, i = path[1].split("_")
            up = kind == "up"
            rest = path[3:-1] if up else path[2:-1]
            stem, role = _reference_resnet_key(rest)
            prefix = f"{net}.model.{kind}_modules.{i}.{stem}"
        elif path[0] == "scorer_head":
            prefix, role, up = "ScorerHead.0", "linear", False
        elif path[0] in _HEADS:
            head, part = _HEADS[path[0]]
            up = False
            if part == "out":
                prefix, role = f"{head}.1", "linear"
            elif path[1] == "Dense_0":
                prefix, role = f"{head}.0.0.0", "linear"
            else:
                prefix, role = f"{head}.0.0.1", "bn"
        else:
            raise KeyError(f"{name} has no place in the reference's PointGroup3heads layout")
        if role == "conv":
            sd[prefix + ".kernel"] = torch.from_numpy(
                np.ascontiguousarray((arr[::-1] if up else arr)[inv]))
        elif role == "shortcut":
            sd[prefix + ".kernel"] = torch.from_numpy(arr)
        elif role == "linear":
            sd[prefix + (".weight" if leaf == "kernel" else ".bias")] = torch.from_numpy(
                np.ascontiguousarray(arr.T if leaf == "kernel" else arr))
        else:
            sd[f"{prefix}.bn.{_BN_LEAVES[leaf]}"] = torch.from_numpy(arr)
            sd[f"{prefix}.bn.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return sd
