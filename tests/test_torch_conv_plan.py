"""The launch plans of the bf16 tensor-core kernels A and D
(``ops/conv.py:conv_plan``, ``dw_plan``) and the wrappers' layout check, at
every conv shape of the flagship's forward and full train step (backbone
and ScoreNet, 131,072 rows) and of the serving tile (32,768 rows), on the
CPU: the kernels themselves run only on the card (``chip_smoke.py``).

* the shapes come from the model's own walk: a forward and backward of
  both UNets on a small hierarchy launch exactly the convs listed here;
* A's offset groups partition 0..26 in order, and the ordered sum of the
  groups' plain convs is the plain conv (f32, 1e-6 relative: the same
  products summed in another order) and the JAX package's conv (1e-5, as
  ``test_torch_conv.py``). The kernel's own split, workspace and second
  pass run only on the card, where ``chip_smoke.py`` holds every split
  shape against the plain conv and checks that a second launch repeats
  bit for bit;
* the Cout tiles cover Cout with less than 8 channels of padding, in widths
  the kernels instantiate;
* the workspaces stay under their caps; D has at most one row group per
  32-row chunk and at most 1,024 chunks a group;
* the layout check raises on misaligned or non-packed operands.
"""

import math

import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.ops.conv import sparse_conv as j_conv
from panopticsegforlargescalepointcloud_tpu_torch.data import collate_tiles, synthetic_tile
from panopticsegforlargescalepointcloud_tpu_torch.models.plans import (
    paper_backbone_plan,
    scorer_unet_plan,
)
from panopticsegforlargescalepointcloud_tpu_torch.models.unet import SparseUNet
from panopticsegforlargescalepointcloud_tpu_torch.ops import conv
from panopticsegforlargescalepointcloud_tpu_torch.ops.hierarchy import (
    build_hierarchy,
    default_capacities,
)
from panopticsegforlargescalepointcloud_tpu_torch.ops.sparse import make_grid
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

BF16 = torch.bfloat16


def unet_convs(plan, caps):
    """(N_out, N_in, Cin, Cout) of every conv of ``SparseUNet.forward`` over
    level capacities ``caps``, in call order (the model's walk: a strided
    first conv keeps Cin, its ResBlocks widen; ups concatenate the skip)."""
    convs, level = [], 0

    def module(cin, cout, stride, to):
        first = cin if stride > 1 else cout
        convs.append((caps[to], caps[level], cin, first))
        c = first
        for _ in range(plan["num_blocks"]):
            convs.append((caps[to], caps[to], c, cout))
            convs.append((caps[to], caps[to], cout, cout))
            c = cout

    for (cin, cout), s in zip(plan["down_channels"], plan["down_strides"]):
        to = level + (s > 1)
        module(cin, cout, s, to)
        level = to
    for (cin, cout), s in zip(plan["up_channels"], plan["up_strides"]):
        to = level - (s > 1)
        module(cin, cout, s, to)
        level = to
    return convs


def _roles(convs, train, input_grad=False):
    """(role, N_out, Cin, Cout) launches: A per conv; in training also D per
    conv and dX (A on the transpose map, N_in rows, Cout -> Cin) for every
    conv but an input conv whose input needs no gradient (the backbone's;
    the ScoreNet's input carries its gradient to the backbone)."""
    out = []
    for i, (n_out, n_in, cin, cout) in enumerate(convs):
        out.append(("A", n_out, cin, cout))
        if train:
            out.append(("D", n_out, cin, cout))
            if i > 0 or input_grad:
                out.append(("A_dx", n_in, cout, cin))
    return out


FLAGSHIP = sorted(set(
    _roles(unet_convs(paper_backbone_plan(4, 16), default_capacities(131072, 6)), True)
    + _roles(unet_convs(scorer_unet_plan(16), default_capacities(98304, 2)), True, True)))
# the serving tile's backbone, and a ScoreNet grid of 24,576 rows
SERVING = sorted(set(
    _roles(unet_convs(paper_backbone_plan(4, 16), default_capacities(32768, 6)), False)
    + _roles(unet_convs(scorer_unet_plan(16), default_capacities(24576, 2)), False)))
ALL = [("flagship",) + s for s in FLAGSHIP] + [("serving",) + s for s in SERVING]
A_SHAPES = [s for s in ALL if s[1] != "D"]
D_SHAPES = [s for s in ALL if s[1] == "D"]


@pytest.fixture(scope="module")
def small_hier():
    """A 7-level hierarchy of two synthetic tiles in 4,096 rows."""
    rng = np.random.default_rng(7)
    vb = collate_tiles([synthetic_tile(rng, n_instances=4, pts_per_instance=80)
                        for _ in range(2)], capacity=4096, num_tiles=2)
    grid, _ = make_grid(torch.from_numpy(vb.batch), torch.from_numpy(vb.coords),
                        torch.from_numpy(vb.mask))
    return build_hierarchy(grid, 6, device="cpu")


@pytest.mark.parametrize("net,plan,input_grad", [
    ("backbone", paper_backbone_plan(4, 16), False),
    ("scorenet", scorer_unet_plan(16), True),
])
def test_the_walk_matches_the_recorded_flagship_launches(small_hier, monkeypatch, net, plan,
                                                         input_grad):
    """A forward and backward of the UNet launch, through the conv
    wrappers, exactly :func:`unet_convs`'s convs in call order (A) and
    :func:`_roles`'s dX and D launches, at the hierarchy's capacities."""
    found = []
    fwd0, dw0 = conv.sparse_conv_fwd, conv.sparse_conv_dw

    def fwd(feats, idx, weights, kernel=conv.KERNEL):
        role = "A" if kernel is conv.KERNEL else "A_dx"
        found.append((role, idx.shape[0], feats.shape[0], feats.shape[1], weights.shape[2]))
        return fwd0(feats, idx, weights, kernel)

    def dw(feats, idx, g):
        found.append(("D", idx.shape[0], feats.shape[0], feats.shape[1], g.shape[1]))
        return dw0(feats, idx, g)

    monkeypatch.setattr(conv, "sparse_conv_fwd", fwd)
    monkeypatch.setattr(conv, "sparse_conv_dw", dw)
    torch.manual_seed(0)
    model = SparseUNet(**plan)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.1)
    caps = [g.capacity for g in small_hier.grids]
    x = torch.randn((caps[0], plan["down_channels"][0][0]), requires_grad=input_grad)
    model(x, small_hier).square().sum().backward()
    want = unet_convs(plan, caps)
    assert [f[1:] for f in found if f[0] == "A"] == want
    assert sorted((r, n_out, cin, cout) for r, n_out, _, cin, cout in found) == \
        sorted(_roles(want, True, input_grad))


@pytest.mark.parametrize("where,role,n_out,cin,cout", A_SHAPES)
def test_offset_groups_partition_the_offsets(where, role, n_out, cin, cout):
    plan = conv.conv_plan(n_out, cin, cout, 27, BF16)
    groups = conv.offset_groups(plan, 27)
    assert len(groups) == plan.splits >= 1
    assert [k for g in groups for k in g] == list(range(27))
    assert all(len(g) > 0 for g in groups)
    if cin % 16:
        assert plan.splits == 1  # steps that straddle offsets are not split
    # split exactly where the row tiles x Cout tiles would not fill the card
    # (2 blocks per SM), into at most 9 groups
    blocks = math.ceil(n_out / plan.bm) * conv.cout_tiles(cout)[1]
    assert (plan.splits > 1) == (blocks < 264 and cin % 16 == 0)
    assert plan.splits <= 9


@pytest.mark.parametrize("where,role,n_out,cin,cout", ALL)
def test_cout_tiles_cover_cout_with_little_padding(where, role, n_out, cin, cout):
    bn, n_tiles = conv.cout_tiles(cout)
    assert bn in conv.TILE_WIDTHS
    assert 0 <= bn * n_tiles - cout < 8
    plan = conv.conv_plan(n_out, cin, cout, 27, BF16) if role != "D" else \
        conv.dw_plan(n_out, 27, cin, cout, BF16)
    assert plan.bn in conv.TILE_WIDTHS
    assert 0 <= plan.bn * plan.n_tiles - cout < 8
    # the widest tiles, unless a split conv halves them to fill the card
    assert (plan.bn, plan.n_tiles) in ((bn, n_tiles), (bn // 2, 2 * n_tiles))


@pytest.mark.parametrize("where,role,n_out,cin,cout", A_SHAPES)
def test_a_workspace_under_its_cap(where, role, n_out, cin, cout):
    plan = conv.conv_plan(n_out, cin, cout, 27, BF16)
    assert plan.workspace_bytes <= conv._A_WORKSPACE_BYTES
    assert plan.workspace_bytes == (plan.splits * n_out * cout * 4 if plan.splits > 1 else 0)
    assert conv.conv_plan(n_out, cin, cout, 27, torch.float32).splits == 1


@pytest.mark.parametrize("where,role,n_out,cin,cout", D_SHAPES)
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_d_row_groups(where, role, n_out, cin, cout, dtype):
    plan = conv.dw_plan(n_out, 27, cin, cout, dtype)
    chunk = 32 if dtype == BF16 else 64
    chunks = math.ceil(n_out / chunk)
    assert 1 <= plan.groups <= chunks  # at most one group per chunk
    assert plan.workspace_bytes <= conv._DW_WORKSPACE_BYTES
    assert plan.rows_per_group * plan.groups >= n_out
    if dtype == BF16:
        assert plan.rows_per_group % chunk == 0
        assert plan.m_tiles == math.ceil(27 * cin / 64)
    else:  # the CUDA-core kernel's plan: 64-row chunks, 64-wide tiles
        tiles = math.ceil(cin / 64) * math.ceil(cout / 64)
        want = math.ceil(conv._BLOCKS / (27 * tiles))
        cap = conv._DW_WORKSPACE_BYTES // (27 * cin * cout * 4)
        assert plan.groups == max(1, min(want, cap, chunks))


def _random_map(rng, n_out, n_in, density=0.3):
    idx = rng.integers(0, n_in, size=(n_out, 27))
    idx[rng.random((n_out, 27)) > density] = -1
    return torch.from_numpy(idx.astype(np.int32))


SPLIT_SHAPES = sorted({(cin, cout) for _, role, n_out, cin, cout in A_SHAPES
                       if conv.conv_plan(n_out, cin, cout, 27, BF16).splits > 1})


def test_some_flagship_and_serving_convs_split():
    assert len(SPLIT_SHAPES) >= 5


@pytest.mark.parametrize("cin,cout", SPLIT_SHAPES)
def test_ordered_group_sum_equals_the_plain_conv(cin, cout):
    """Each group's conv is the plain conv with the other groups' offsets
    absent; their sum in group order equals the plain conv and the JAX
    package's conv."""
    rng = np.random.default_rng(cin * 1000 + cout)
    n_in, n_out = 300, 200
    idx = _random_map(rng, n_out, n_in)
    x = torch.from_numpy(rng.normal(size=(n_in, cin)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(27, cin, cout)) / math.sqrt(27 * cin))
                         .astype(np.float32))
    # the plan of a deep-level shape with this width (fewer rows than blocks)
    plan = conv.conv_plan(1536, cin, cout, 27, BF16)
    assert plan.splits > 1
    total = torch.zeros((n_out, cout))
    for g in conv.offset_groups(plan, 27):
        keep = torch.zeros(27, dtype=torch.bool)
        keep[list(g)] = True
        total = total + conv.sparse_conv_plain(x, torch.where(keep, idx, -1), w)
    want = conv.sparse_conv_plain(x, idx, w)
    np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    ref = np.asarray(j_conv(x.numpy(), idx.numpy(), w.numpy()))
    np.testing.assert_allclose(total.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_check_rows():
    conv.check_rows("x", 0x1000, 16, 16, BF16)
    conv.check_rows("x", 0x1008, 4, 4, BF16, gathered=True)
    with pytest.raises(ValueError, match="packed"):
        conv.check_rows("x", 0x1000, 16, 32, BF16)
    with pytest.raises(ValueError, match="16-byte"):
        conv.check_rows("x", 0x1008, 16, 16, BF16)
    with pytest.raises(ValueError, match="16-byte"):
        conv.check_rows("w", 0x1000, 12, 12, BF16)  # 24-byte rows
    with pytest.raises(ValueError, match="8-byte"):
        conv.check_rows("x", 0x1004, 4, 4, BF16, gathered=True)


def test_gather_width():
    """Gathered feats rows go in 16-byte segments where Cin % 8 == 0 and in
    8-byte ones where Cin % 8 == 4; rows read whole always in 16-byte ones;
    no other Cin is taken."""
    for cin in (4, 8, 12, 16, 192):
        width = 16 if cin % 8 == 0 else 8
        conv.check_rows("x", 0x1000 + width, cin, cin, BF16, gathered=True)
        if width == 8:
            with pytest.raises(ValueError, match="16-byte"):
                conv.check_rows("w", 0x1000, cin, cin, BF16)
        else:
            with pytest.raises(ValueError, match="16-byte"):
                conv.check_rows("x", 0x1008, cin, cin, BF16, gathered=True)
    with pytest.raises(ValueError, match="16-byte"):
        conv.check_rows("x", 0x1000, 6, 6, BF16, gathered=True)


def test_tc_operand_check_on_tensors():
    base = torch.zeros(4096, dtype=BF16)
    x = base[:64 * 16].view(64, 16)
    w = torch.zeros((27, 16, 32), dtype=BF16)
    conv.check_tc_operands("sparse_conv", x, w)
    with pytest.raises(ValueError, match="feats: rows must start"):
        conv.check_tc_operands("sparse_conv", base[1:1 + 64 * 16].view(64, 16), w)
    with pytest.raises(ValueError, match="feats: rows must be packed"):
        conv.check_tc_operands("sparse_conv", base.view(128, 32)[:, :16], w)
    with pytest.raises(ValueError, match="weights: rows must start"):
        conv.check_tc_operands("sparse_conv", x, torch.zeros((27, 16, 12), dtype=BF16))
    with pytest.raises(ValueError, match="g: rows must be packed"):
        conv.check_tc_operands("sparse_conv_dw", x, torch.zeros((64, 64), dtype=BF16)[:, :32])
    # no Cin limit: the step table is sized by the launch
    conv.check_tc_operands("sparse_conv", torch.zeros((4, 272), dtype=BF16),
                           torch.zeros((27, 272, 16), dtype=BF16))
    # f32 operands go to the CUDA-core bodies, which take any layout they are given
    conv.check_tc_operands("sparse_conv", torch.zeros((4, 3)), torch.zeros((27, 3, 5)))


def test_operand_check():
    x = torch.zeros((64, 16), dtype=BF16)
    w = torch.zeros((27, 16, 32), dtype=BF16)
    idx = torch.zeros((8, 27), dtype=torch.int32)
    conv.check_operands("sparse_conv", x, w, idx)
    with pytest.raises(TypeError, match="one dtype"):
        conv.check_operands("sparse_conv", x, w.float(), idx)
    with pytest.raises(TypeError, match="int32"):
        conv.check_operands("sparse_conv", x, w, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        conv.check_operands("sparse_conv", x, w, idx.T.contiguous().T)
    with pytest.raises(ValueError, match="rows must start"):
        conv.check_operands("sparse_conv", x, torch.zeros((27, 16, 12), dtype=BF16), idx)
