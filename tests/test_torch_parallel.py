"""The data-parallel train step: the port's ``make_parallel_train_step`` on
two gloo CPU ranks (started by ``parallel.launch.spawn``) against the JAX
package's ``make_parallel_train_step`` on two of the virtual CPU devices,
from the same weights, BN statistics and stacked batch
(``stack_device_batches`` of two ``synthetic_tile``s at capacity 1,024;
tiny plan, f32; the JAX side with ``use_winconv="off"`` and
``rg_dense="on"``, as its own tests run it). Two cases, two steps each:
the flagship's prepare step with ``grad_clip_value`` 0.01 (it binds), and
the full step with ``grad_accum`` 2 (one update, at the second step) of an
embed strategy that draws random subsets (cluster type 12: region growing
on positions, then mean shift on six random subsets of the embedding),
whose proposals show the mesh step's subset draw without a counter. The
optimizer is SGD (momentum 0.9): Adam divides each gradient element by its
own size, so an element whose exact gradient is about 0 (embed_out's bias:
the discriminative loss does not change when every embedding shifts) moves
by the lr in the direction its rounding takes, in either package.

Tolerances: every loss term of each step within rtol 1e-4, atol 1e-5 (f32
sums in another order through the UNet); after the two steps every weight
tensor within 1e-4 of its max |value| (plus ``WEIGHT_FLOOR``) and every BN
running statistic within 1e-5 of its max |value|; the proposals exactly;
the two ranks' replicas (every parameter and buffer) bit-identical after
each step."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu.config.schema import (
    training_config_from_yaml as j_training_config,
)
from panopticsegforlargescalepointcloud_tpu.data import (
    collate_tiles,
    stack_device_batches as j_stack,
    synthetic_tile,
)
from panopticsegforlargescalepointcloud_tpu.models.pointgroup3heads import (
    PanopticConfig as JConfig,
    PointGroup3HeadsNet as JNet,
)
from panopticsegforlargescalepointcloud_tpu.ops.hierarchy import build_hierarchy as j_hier
from panopticsegforlargescalepointcloud_tpu.parallel import (
    make_mesh as j_make_mesh,
    make_parallel_train_step as j_parallel_step,
    replicate as j_replicate,
    shard_batch as j_shard_batch,
)
from panopticsegforlargescalepointcloud_tpu.train.optim import (
    build_from_config as j_build_from_config,
)
from panopticsegforlargescalepointcloud_tpu.train.step import (
    TrainState as JTrainState,
    batch_arrays,
    canonicalize as j_canon,
    panoptic_forward as j_panoptic_forward,
)
from panopticsegforlargescalepointcloud_tpu_torch.config.schema import training_config_from_yaml
from panopticsegforlargescalepointcloud_tpu_torch.data import stack_device_batches
from panopticsegforlargescalepointcloud_tpu_torch.models import PanopticConfig, PointGroup3HeadsNet
from panopticsegforlargescalepointcloud_tpu_torch.parallel import (
    backend_for,
    make_mesh,
    make_parallel_train_step,
    replica_checksum,
    replicate,
    shard_batch,
    spawn,
    visible_devices,
)
from panopticsegforlargescalepointcloud_tpu_torch.train import step as step_module
from panopticsegforlargescalepointcloud_tpu_torch.train.optim import build_from_config
from panopticsegforlargescalepointcloud_tpu_torch.train.step import init_params
from panopticsegforlargescalepointcloud_tpu_torch.weights import flax_paths, params_from_flax
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)

torch.set_num_threads(2)

# a rank left waiting in a collective fails the fixture after this long,
# not after the launcher's default of 30 minutes
RANK_TIMEOUT_S = 300

CFG = dict(num_classes=9, stuff_classes=(0, 7, 8), backbone="tiny", feat_dim=4, in_feat=8,
           num_samples=1, max_instances=16, max_props_rg=32, ms_max_seeds=32,
           ms_max_clusters=8, ms_point_cap=1024, cluster_radius=0.9, compute_dtype="float32")
CASES = {
    "prepare_clip": dict(full=False, clip=0.01, accum=1, model={}),
    "embed12_full_accum2": dict(full=True, clip=None, accum=2,
                                model=dict(model_family="embed", cluster_type=12,
                                           use_score_net=False, loop_max_clusters=4)),
}
STEPS = 2
MOMENTUM = 0.1
SCHEDULE = 750  # steps per epoch of the exponential schedule
LOSSES = dict(rtol=1e-4, atol=1e-5)
WEIGHTS = 1e-4
BN = 1e-5
# the lr (1e-3) times the 1e-6 floor of the gradients' agreement
# (test_torch_train_step.py), summed over two SGD momentum steps (1 + 1.9):
# a parameter that starts at 0 and whose exact gradient is about 0
# (embed_out's bias under the shift-invariant discriminative loss) moves by
# rounding alone
WEIGHT_FLOOR = 3e-9


def _random_stats(tree, rng):
    return {k: (_random_stats(v, rng) if hasattr(v, "items") else
                (np.abs(rng.normal(scale=0.3, size=v.shape)) + 0.5 if k == "var"
                 else rng.normal(scale=0.1, size=v.shape)).astype(np.float32))
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, path) if hasattr(v, "items") else {path: np.asarray(v)})
    return out


def _nest(flat):
    tree = {}
    for path, arr in flat.items():
        node = tree
        *head, leaf = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return tree


def _tcfg_yaml(case):
    return {"training": {"grad_accum": case["accum"], "lr": 1e-3,
                         "optim": {"class": "SGD", "base_lr": 1e-3}}}


def _dp_worker(mesh, case_names, state_dicts, stacked):
    """One rank: per case, the replicated model, the data-parallel step and
    two steps on this rank's block; the step's forward is wrapped to record
    its subset counter and proposals."""
    torch.set_num_threads(1)
    recorded = []
    forward = step_module.panoptic_forward

    def recording(*args, **kwargs):
        out = forward(*args, **kwargs)
        recorded.append((kwargs.get("subset_seed"), out.proposals))
        return out

    step_module.panoptic_forward = recording
    arrays = shard_batch(mesh, stacked)
    results = {}
    for name in case_names:
        case = CASES[name]
        cfg = PanopticConfig(**CFG, **case["model"])
        model = PointGroup3HeadsNet(cfg)
        if mesh.rank == 0:
            model.load_state_dict(state_dicts[name], strict=True)
        replicate(mesh, model)  # the other rank's random init is overwritten
        optimizer, schedule, _ = build_from_config(training_config_from_yaml(_tcfg_yaml(case)),
                                                   SCHEDULE, model.parameters())
        step = make_parallel_train_step(cfg, model, optimizer, schedule, mesh, case["full"],
                                        grad_clip_value=case["clip"], grad_accum=case["accum"])
        recorded.clear()
        metrics, checksums, moved = [], [], []
        for _ in range(STEPS):
            before = [p.detach().clone() for p in model.parameters()]
            metrics.append({k: float(v) for k, v in step(arrays, MOMENTUM).items()})
            checksums.append(replica_checksum(model))
            moved.append(any(not torch.equal(a, p) for a, p in zip(before, model.parameters())))
        props = None
        if recorded and recorded[0][1] is not None:
            props = {k: getattr(recorded[0][1], k).numpy().copy()
                     for k in recorded[0][1]._fields}
        group = optimizer.param_groups[0]
        results[name] = dict(metrics=metrics, checksums=checksums,
                             weights=flax_paths(model.state_dict()), props=props,
                             seeds=[s for s, _ in recorded], moved=moved,
                             calls={k: group.get(k) for k in ("count", "calls")})
    return results


def _tiles():
    rng = np.random.default_rng(3)
    return [collate_tiles([synthetic_tile(rng, n_instances=3, pts_per_instance=50,
                                          n_ground=200)], capacity=1024, num_tiles=1)
            for _ in range(2)]


def _weights(case):
    """The port's initializers with random BN statistics, as flax trees
    (params, batch_stats)."""
    model = init_params(PointGroup3HeadsNet(PanopticConfig(**CFG, **case["model"])),
                        torch.Generator().manual_seed(0))
    flat = flax_paths(model.state_dict())
    stat = {k for k in flat if k.rsplit("/", 1)[1] in ("mean", "var")}
    return (_nest({k: v for k, v in flat.items() if k not in stat}),
            _random_stats(_nest({k: v for k, v in flat.items() if k in stat}),
                          np.random.default_rng(1)))


@pytest.fixture(scope="module")
def runs():
    per_dev = _tiles()
    stacked = j_stack(per_dev)
    arrays = tuple(np.asarray(a) for a in batch_arrays(stacked))
    mesh = j_make_mesh(jax.devices()[:2])
    weights = {name: _weights(case) for name, case in CASES.items()}
    state_dicts = {name: {k: torch.from_numpy(np.array(v))
                          for k, v in params_from_flax(*w).items()}
                   for name, w in weights.items()}
    # the port's ranks are processes of their own: they run while this
    # process computes the JAX side
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn, _dp_worker, ["cpu", "cpu"], list(CASES), state_dicts, arrays,
                           timeout_s=RANK_TIMEOUT_S)
        jax_runs = {name: _jax_run(case, weights[name], mesh, arrays)
                    for name, case in CASES.items()}
        ranks = port.result()
    return dict(jax=jax_runs, ranks=ranks, per_dev=per_dev, arrays=arrays)


def _jax_run(case, weights, mesh, arrays):
    """The JAX mesh step's two steps (and, for a full step, the train-mode
    forward's proposals on each device's block) from ``weights``."""
    params, stats = weights
    jcfg = JConfig(**CFG, **case["model"], use_winconv="off", rg_dense="on")
    jmodel = JNet(jcfg)
    tx, _, _ = j_build_from_config(j_training_config(_tcfg_yaml(case)), SCHEDULE)
    state = JTrainState(step=jnp.asarray(0, jnp.int32),
                        params=jax.tree.map(jnp.asarray, params),
                        batch_stats=jax.tree.map(jnp.asarray, stats),
                        opt_state=tx.init(jax.tree.map(jnp.asarray, params)),
                        bn_momentum=jnp.asarray(MOMENTUM, jnp.float32))
    # the mesh step's forward: train mode, no subset counter
    props = []
    if case["full"]:
        def proposals(block):
            sdb = j_canon(*block)
            out, _ = j_panoptic_forward(
                jcfg, jmodel, {"params": params, "batch_stats": stats}, sdb,
                j_hier(sdb.grid, jcfg.num_down), train=True, with_clustering=True,
                momentum=MOMENTUM)
            return out.proposals._asdict()

        fwd = jax.jit(proposals)
        props = [jax.tree.map(np.asarray, fwd(tuple(a[d] for a in arrays)))
                 for d in range(2)]
    step = j_parallel_step(jcfg, jmodel, tx, mesh, with_clustering=case["full"],
                           grad_clip_value=case["clip"])
    state = j_replicate(mesh, state)
    sharded = j_shard_batch(mesh, tuple(jnp.asarray(a) for a in arrays))
    losses = []
    for _ in range(STEPS):
        state, m = step(state, sharded)
        losses.append({k: float(v) for k, v in m.items()})
    return dict(losses=losses, params=_flat(jax.device_get(state.params)),
                stats=_flat(jax.device_get(state.batch_stats)), props=props,
                step=int(state.step))


def test_stack_device_batches_matches_jax():
    per_dev = _tiles()
    want = j_stack(per_dev)
    got = stack_device_batches(per_dev)
    assert type(got).__name__ == "VoxelBatch" and got._fields == want._fields
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert getattr(got, name).shape[0] == 2


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax(runs, name):
    want = runs["jax"][name]["losses"]
    for got in (r[name]["metrics"] for r in runs["ranks"]):
        assert len(got) == len(want) == STEPS
        for s in range(STEPS):
            assert set(want[s]) <= set(got[s]), (s, set(want[s]) - set(got[s]))
            for k, v in want[s].items():
                np.testing.assert_allclose(got[s][k], v, **LOSSES, err_msg=f"step {s} {k}")
    assert ("ins_loss" in want[0]) == ("ins_loss" in got[0])


@pytest.mark.parametrize("name", list(CASES))
def test_weights_and_bn_statistics_match_jax(runs, name):
    want = {**runs["jax"][name]["params"], **runs["jax"][name]["stats"]}
    got = runs["ranks"][0][name]["weights"]
    assert set(got) == set(want)
    for k, w in want.items():
        frac = BN if k.rsplit("/", 1)[1] in ("mean", "var") else WEIGHTS
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=frac * float(np.abs(w).max()) + WEIGHT_FLOOR, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_replicas_bit_identical(runs, name):
    a, b = (r[name] for r in runs["ranks"])
    assert len(a["checksums"]) == STEPS and a["checksums"] == b["checksums"]
    assert len(set(a["checksums"])) == STEPS
    for k in a["weights"]:
        np.testing.assert_array_equal(a["weights"][k], b["weights"][k], err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_step_counts_and_accumulation(runs, name):
    """Two mini-batches taken; with grad_accum 2 one update, at the second
    step: the first leaves the weights as they were."""
    accum = CASES[name]["accum"]
    assert runs["jax"][name]["step"] == STEPS
    for r in runs["ranks"]:
        assert r[name]["calls"] == {"calls": STEPS, "count": STEPS // accum}
        assert r[name]["moved"] == ([False, True] if accum == 2 else [True, True])


def test_embed_proposals_without_counter(runs):
    """The mesh step draws the fixed random subsets (no counter): each
    rank's proposals equal the JAX train-mode forward's without
    ``subset_seed`` on its block, at both steps' counters."""
    for rank, r in enumerate(runs["ranks"]):
        res = r["embed12_full_accum2"]
        assert res["seeds"] == [None] * STEPS
        want = runs["jax"]["embed12_full_accum2"]["props"][rank]
        assert set(res["props"]) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(res["props"][k], v, err_msg=k)
        assert int(want["prop_valid"].sum()) >= 2


def test_backend_follows_the_device_list():
    """gloo for CPU ranks and ranks that share a card; nccl when every rank
    has a card of its own. Nothing else picks it."""
    assert backend_for(["cpu", "cpu"]) == "gloo"
    assert backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert backend_for(["cuda", "cuda:0"]) == "gloo"  # a bare cuda is card 0
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert backend_for(["cuda:0"]) == "nccl"
    assert backend_for(["cpu", "cuda:0"]) == "gloo"


def test_entry_points_default_to_gpu():
    assert visible_devices(3, "cpu") == [torch.device("cpu")] * 3
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        visible_devices(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(_dp_worker, ["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="started process group"):
        make_mesh(["cpu"])
