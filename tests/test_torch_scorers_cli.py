"""The train and eval CLIs on the CPU at tiny width with the mask head (its
epoch gates open from epoch 1) and with the encoder scorer: two epochs on a
synthetic forest, the second with clustering, then the eval CLI from that
checkpoint. The modules and the first full step of these forms against
the JAX package are in ``test_torch_scorers.py``."""

import json

import numpy as np
import pytest
import torch

from panopticsegforlargescalepointcloud_tpu_torch.cli import eval as cli_eval
from panopticsegforlargescalepointcloud_tpu_torch.cli import train as cli_train
from test_data import make_forest_ply
from test_torch_mask_head import MASK

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def forest(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("forest") / "forest.ply")
    make_forest_ply(path, np.random.default_rng(2022), n_trees=4, extent=14.0)
    return path


@pytest.mark.parametrize("over", [
    [f"models.PointGroup-PAPER.{k}={v}" for k, v in MASK.items()]
    + ["models.PointGroup-PAPER.use_mask_filter_score_feature_start_epoch=1",
       "models.PointGroup-PAPER.cal_iou_based_on_mask_start_epoch=1"],
    ["models.PointGroup-PAPER.scorer_type=encoder"],
], ids=["mask", "encoder"])
def test_cli_train_then_eval(forest, tmp_path, over):
    """Two epochs of the tiny model (the second with clustering, past the
    gates' start epoch 1) on the forest, then the eval CLI with that
    checkpoint, which rebuilds the same model from the run config."""
    run_dir = tmp_path / "run"
    model = "models.PointGroup-PAPER"
    trainer = cli_train.main([
        "data=panoptic/treeins_rad8", "backbone=tiny", "device=cpu", "pretty_print=False",
        "training.epochs=2", "training.batch_size=2", "training.samples_per_epoch=4",
        "training.num_workers=0", "data.voxel_capacity=4096", "data.eval_voxel_capacity=4096",
        "data.radius=6", f"checkpoint_dir={run_dir}", f"{model}.feat_size=8",
        f"{model}.prepare_epoch=1", f"data.files.train=[{forest}]",
        f"data.files.val=[{forest}]"] + over)
    pcfg = trainer.pcfg
    assert pcfg.mask_supervise == ("mask" in over[0]) and pcfg.scorer_type in ("unet",
                                                                               "encoder")
    assert list(trainer._full_steps) == [pcfg.gates(2)]
    lines = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 2
    for line in lines:
        assert all(np.isfinite(v) for k, v in line.items() if k.startswith("train_"))
    assert ("train_mask_loss" in lines[1]) == pcfg.mask_supervise
    assert "train_score_loss" in lines[1] and "train_rg_graph_trunc" in lines[1]
    reports = cli_eval.main([f"checkpoint_dir={run_dir}", "device=cpu",
                             f"data.files.test=[{forest}]", f"out_dir={tmp_path / 'eval'}"])
    assert len(reports) == 1
    assert all(np.isfinite(reports[0][k]) for k in ("mIoU", "meanPQ", "F1"))
    assert (tmp_path / "eval" / "Evaluation_0.txt").exists()
