"""Reference torch-points3d checkpoints into the port without JAX.

* The port's MinkowskiEngine kernel enumeration and its permutation into
  the port's z-fastest order equal the repo tool's
  (``tools/import_torch_checkpoint.py``).
* The whole chain against dense ``torch`` oracles, on the port's plain conv
  (the kernel's CPU path): a torch ``Conv3d``/``ConvTranspose3d`` weight,
  re-expressed in ME's layout, imported by the importer's rules (ME order
  permuted; the up modules' K axis reversed) and run through the port's
  maps on a dense two-sample grid equals ``conv3d``/``conv_transpose3d`` in
  four forms: submanifold, stride-2 down, stride-2 transpose and the
  stride-1 transpose of an up module's ResBlock. f32, within 1e-4 of
  max |want|. The kernels are random: a wrong permutation would pass with
  a symmetric one.
* ``params_from_reference`` equals, bit for bit, ``params_from_flax`` of the
  tool's ``convert_state_dict`` with ME order, at the tiny and the paper
  plan, for both BN spellings and both shortcut layouts; and
  ``reference_from_params`` is its inverse.
* The import CLI writes a port checkpoint that the eval CLI's
  ``build_evaluator`` loads on the CPU, refuses a run config that the
  port's ``weights_only`` read would reject, and runs in a subprocess where
  ``jax``, ``flax``, ``optax`` and the JAX package cannot be imported.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import import_torch_checkpoint as tool  # noqa: E402

from panopticsegforlargescalepointcloud_tpu_torch.cli import eval as cli_eval  # noqa: E402
from panopticsegforlargescalepointcloud_tpu_torch.cli import (  # noqa: E402
    import_torch_checkpoint as cli_import,
)
from panopticsegforlargescalepointcloud_tpu_torch.config import load_config  # noqa: E402
from panopticsegforlargescalepointcloud_tpu_torch.data.ply import write_ply  # noqa: E402
from panopticsegforlargescalepointcloud_tpu_torch.flagship import random_model  # noqa: E402
from panopticsegforlargescalepointcloud_tpu_torch.models import PanopticConfig  # noqa: E402
from panopticsegforlargescalepointcloud_tpu_torch.ops.conv import sparse_conv  # noqa: E402
from panopticsegforlargescalepointcloud_tpu_torch.ops.sparse import (  # noqa: E402
    _kernel_offsets,
    down_map,
    downsample,
    make_grid,
    same_level_map,
    up_map,
)
from panopticsegforlargescalepointcloud_tpu_torch.train.checkpoint import (  # noqa: E402
    ModelCheckpoint,
)
from panopticsegforlargescalepointcloud_tpu_torch.weights import (  # noqa: E402
    me_kernel_offsets,
    me_to_ours_perm,
    params_from_flax,
    params_from_reference,
    reference_from_params,
)

torch.set_num_threads(2)

TINY = dict(num_down_blocks=3, num_up_blocks=3, n_res=1)
TINY_CFG = dict(num_classes=9, stuff_classes=(0, 7, 8), backbone="tiny", feat_dim=4,
                in_feat=8, num_samples=1)
PAPER_CFG = dict(num_classes=9, stuff_classes=(0, 7, 8), backbone="paper", feat_dim=4,
                 in_feat=16, num_samples=1)


# ---------------------------------------------------------------- enumeration


@pytest.mark.parametrize("k", [1, 2, 3])
def test_me_enumeration_matches_tool(k):
    np.testing.assert_array_equal(me_kernel_offsets(k), tool.me_kernel_offsets(k))
    assert me_kernel_offsets(k).dtype == np.int32


@pytest.mark.parametrize("k", [1, 2, 3])
def test_me_permutation_matches_tool(k):
    perm = me_to_ours_perm(k)
    np.testing.assert_array_equal(perm, tool.me_to_ours_perm(k))
    np.testing.assert_array_equal(me_kernel_offsets(k)[perm], _kernel_offsets(k))


def test_me_permutation_is_base3_digit_reversal():
    offs = me_kernel_offsets(3)
    np.testing.assert_array_equal(offs[[0, 1, 3, 9, 26]],
                                  [[-1, -1, -1], [0, -1, -1], [-1, 0, -1], [-1, -1, 0],
                                   [1, 1, 1]])
    perm = me_to_ours_perm(3)
    for k in range(27):
        a, b, c = k // 9, (k // 3) % 3, k % 3
        assert perm[k] == 9 * c + 3 * b + a


# ---------------------------------------------------------- dense conv parity

N, CIN, COUT, SAMPLES = 6, 4, 8, 2


def dense_grid(n):
    """Every voxel of [0, n)^3 in each of SAMPLES samples, canonical."""
    xyz = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), -1).reshape(-1, 3)
    coords = np.tile(xyz, (SAMPLES, 1)).astype(np.int32)
    batch = np.repeat(np.arange(SAMPLES), len(xyz)).astype(np.int32)
    grid, _ = make_grid(torch.from_numpy(batch), torch.from_numpy(coords),
                        torch.ones(len(coords), dtype=torch.bool))
    return grid


def to_dense(grid, feats, n):
    """[SAMPLES, C, n, n, n] with the grid's valid rows placed at their
    coordinates."""
    m = grid.mask
    c, b = grid.coords[m].long(), grid.batch[m].long()
    out = torch.zeros(SAMPLES, feats.shape[1], n, n, n)
    out[b, :, c[:, 0], c[:, 1], c[:, 2]] = feats[m]
    return out


def from_dense(grid, dense):
    m = grid.mask
    c, b = grid.coords[m].long(), grid.batch[m].long()
    return dense[b, :, c[:, 0], c[:, 1], c[:, 2]]


def me_kernel(wt: np.ndarray, transpose: bool) -> np.ndarray:
    """A torch Conv3d [Cout, Cin, k, k, k] (or ConvTranspose3d [Cin, Cout,
    k, k, k]) weight in ME's layout [K, Cin, Cout], K enumerated x-fastest
    by the offset ki - 1 of each axis."""
    offs = me_kernel_offsets(3) + 1
    w = wt[:, :, offs[:, 0], offs[:, 1], offs[:, 2]]  # [A, B, K]
    return np.ascontiguousarray(np.moveaxis(w, 2, 0) if transpose
                                else np.moveaxis(w, 2, 0).transpose(0, 2, 1))


def imported(w_me: np.ndarray, up: bool) -> torch.Tensor:
    """The importer's rule: ME order permuted; an up module's K reversed."""
    w = w_me[me_to_ours_perm(3)]
    return torch.from_numpy(np.ascontiguousarray(w[::-1] if up else w))


FORMS = ["submanifold", "down", "transpose", "transpose_stride1"]


@pytest.mark.parametrize("form", FORMS)
def test_dense_parity(form):
    """The port's conv through its map, with the kernel imported from a
    torch weight, against the dense torch op on the same grid."""
    rng = np.random.default_rng(FORMS.index(form))
    fine = dense_grid(N)
    coarse, _ = downsample(fine, SAMPLES * (N // 2) ** 3)
    transpose = form.startswith("transpose")
    # (source grid, its side, output grid, map, the dense op's keywords)
    src, n_src, dst, nbr, kw = {
        "submanifold": (fine, N, fine, same_level_map(fine), dict(padding=1)),
        "down": (fine, N, coarse, down_map(fine, coarse), dict(stride=2, padding=1)),
        "transpose": (coarse, N // 2, fine, up_map(fine, coarse),
                      dict(stride=2, padding=1, output_padding=1)),
        "transpose_stride1": (fine, N, fine, same_level_map(fine), dict(padding=1)),
    }[form]
    feats = torch.from_numpy(rng.normal(size=(src.capacity, CIN)).astype(np.float32))
    wt = rng.normal(size=(CIN, COUT, 3, 3, 3) if transpose
                    else (COUT, CIN, 3, 3, 3)).astype(np.float32)
    op = torch.nn.functional.conv_transpose3d if transpose else torch.nn.functional.conv3d
    want = from_dense(dst, op(to_dense(src, feats, n_src), torch.from_numpy(wt), **kw))
    got = sparse_conv(feats, nbr, imported(me_kernel(wt, transpose), up=transpose))[dst.mask]
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


def test_transpose_needs_the_reversal():
    """Without the up modules' reversal the transpose form is wrong: the
    parity test above would catch a dropped reversal."""
    rng = np.random.default_rng(9)
    fine = dense_grid(N)
    coarse, _ = downsample(fine, SAMPLES * (N // 2) ** 3)
    feats = torch.from_numpy(rng.normal(size=(coarse.capacity, CIN)).astype(np.float32))
    wt = rng.normal(size=(CIN, COUT, 3, 3, 3)).astype(np.float32)
    want = from_dense(fine, torch.nn.functional.conv_transpose3d(
        to_dense(coarse, feats, N // 2), torch.from_numpy(wt), stride=2, padding=1,
        output_padding=1))
    got = sparse_conv(feats, up_map(fine, coarse), imported(me_kernel(wt, True), up=False))
    assert float((got[fine.mask] - want).abs().max()) > 1e-2 * float(want.abs().max())


# ------------------------------------------------------ state-dict conversion


def reference_sd(cfg_kw, seed=0):
    model = random_model(PanopticConfig(**cfg_kw), seed)
    return model, reference_from_params(model.state_dict())


def tool_state_dict(sd, **plan):
    params, stats = tool.convert_state_dict({k: v.numpy() for k, v in sd.items()},
                                            offset_perm=tool.me_to_ours_perm(3), **plan)
    return params_from_flax(params, stats)


def assert_bitwise(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("plan", ["tiny", "paper"])
def test_params_from_reference_matches_tool(plan):
    cfg_kw, kw = (TINY_CFG, TINY) if plan == "tiny" else (PAPER_CFG, {})
    model, sd = reference_sd(cfg_kw)
    got = params_from_reference(sd, offset_perm=me_to_ours_perm(3), **kw)
    assert_bitwise(got, tool_state_dict(sd, **kw))
    # and the round trip: the seeded model's own tensors, loaded strictly
    assert_bitwise(got, model.state_dict())
    model.load_state_dict(got, strict=True)


def test_reference_spellings_and_shortcut_layouts():
    """``batch_norm.`` spellings and [1, Cin, Cout] shortcuts read as the
    tool reads them; keys the map does not read are ignored."""
    model, sd = reference_sd(TINY_CFG, seed=3)
    alt = {}
    for k, v in sd.items():
        if k.startswith(("Semantic", "Offset", "Embed")):
            k = k.replace(".bn.", ".batch_norm.")
        if k.endswith("downsample.0.kernel"):
            v = v[None]
        alt[k] = v
    alt["Backbone.model.unused.weight"] = torch.zeros(3)
    assert any(k.endswith("num_batches_tracked") for k in alt)
    got = params_from_reference(alt, offset_perm=me_to_ours_perm(3), **TINY)
    assert_bitwise(got, tool_state_dict(alt, **TINY))
    assert_bitwise(got, model.state_dict())


def test_reference_layout():
    """The emitted file is in the reference's layout: ME order, the up
    modules' kernels reversed, Linear [out, in], a counter per BN."""
    model, sd = reference_sd(TINY_CFG, seed=4)
    ours = model.state_dict()
    perm = me_to_ours_perm(3)
    k_down = ours["backbone.down_1.ConvBNReLU_0.SparseConv_0.kernel"]
    assert torch.equal(sd["Backbone.model.down_modules.1.conv_in.0.kernel"][perm], k_down)
    k_up = ours["backbone.up_0.up.ResBlock_0.ConvBNReLU_1.SparseConv_0.kernel"]
    got = sd["Backbone.model.up_modules.0.blocks.0.block.3.kernel"][perm].flip(0)
    assert torch.equal(got, k_up)
    assert torch.equal(sd["Semantic.1.weight"], ours["semantic_out.weight"])
    assert sd["Semantic.0.0.1.bn.num_batches_tracked"].dtype == torch.int64
    with pytest.raises(KeyError, match="no BN"):
        params_from_reference({k: v for k, v in sd.items() if ".conv_in.1." not in k}, **TINY)
    with pytest.raises(KeyError, match="reference's PointGroup3heads layout"):
        reference_from_params({"mask_score_a.weight": torch.zeros(2, 2)})


# ------------------------------------------------------------------------ CLI


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """A reference file of seeded paper-plan weights of ``conf/eval.yaml``'s
    model, with that composed config (plain dicts) as its run config."""
    tmp = tmp_path_factory.mktemp("reference")
    run_cfg = load_config(cli_eval.CONF_DIR, [], root="eval.yaml")
    model = random_model(cli_eval.model_config(run_cfg)[0], 7)
    path = str(tmp / "ref.pt")
    torch.save({"models": {"latest": reference_from_params(model.state_dict())},
                "run_config": run_cfg, "optimizer": None}, path)
    rng = np.random.default_rng(0)
    ply = str(tmp / "scene.ply")
    write_ply(ply, [rng.uniform(0, 4, (300, 3)).astype(np.float32), np.ones(300, np.int32),
                    np.full(300, -1, np.int32)], ["x", "y", "z", "semantic_seg", "treeID"])
    return dict(tmp=tmp, path=path, model=model, run_cfg=run_cfg, ply=ply)


def test_cli_checkpoint_serves_on_cpu(serving, monkeypatch):
    out = str(serving["tmp"] / "imported")
    cli_import.main([serving["path"], out])
    ck = ModelCheckpoint(out)
    assert ck.run_config == serving["run_cfg"]
    assert_bitwise(ck.get_weights("latest")["state_dict"], serving["model"].state_dict())
    loaded = []
    load0 = cli_eval.PointGroup3HeadsNet.load_state_dict

    def load(self, sd, strict=True):
        loaded.append((sd, strict))
        return load0(self, sd, strict)

    monkeypatch.setattr(cli_eval.PointGroup3HeadsNet, "load_state_dict", load)
    ev, _, _, _ = cli_eval.build_evaluator([f"checkpoint_dir={out}",
                                            f"data.files.test=[{serving['ply']}]",
                                            "device=cpu"])
    assert ev.device.type == "cpu" and len(loaded) == 1 and loaded[0][1]
    assert_bitwise(loaded[0][0], serving["model"].state_dict())


def test_cli_refuses_a_run_config_weights_only_rejects(serving):
    path = str(serving["tmp"] / "bad.pt")
    blob = torch.load(serving["path"], weights_only=False)
    blob["run_config"]["data"]["root"] = pathlib.PurePosixPath("/data")
    torch.save(blob, path)
    with pytest.raises(TypeError, match="run_config.data.root.*PurePosixPath"):
        cli_import.main([path, str(serving["tmp"] / "bad_out")])


def test_cli_runs_without_jax(serving):
    out = str(serving["tmp"] / "nojax")
    code = ("import sys, runpy\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', "
            "'panopticsegforlargescalepointcloud_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = ['import_torch_checkpoint', {serving['path']!r}, {out!r}]\n"
            "runpy.run_module('panopticsegforlargescalepointcloud_tpu_torch.cli."
            "import_torch_checkpoint', run_name='__main__')\n"
            "assert not any(m.split('.')[0] in ('jax', 'flax', 'optax') "
            "for m, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "imported latest" in res.stdout
    assert "reference keys not read" in res.stderr
    assert_bitwise(ModelCheckpoint(out).get_weights()["state_dict"],
                   serving["model"].state_dict())
