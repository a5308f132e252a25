"""Tiny versions of the benchmark's configurations and traffic for the CPU
tests: the tiny UNet, small budgets and small inputs, f32."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

BUDGETS = dict(max_instances=16, max_props_rg=32, ms_max_seeds=32,
               ms_max_clusters=8, ms_point_cap=2048, rg_point_cap=0.5,
               scorer_capacity_mult=1.0, min_cluster_points=10)


def load(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def manifest():
    return load(ROOT, "BENCHMARK.json")


def cell(name):
    """The manifest's cell, or for a cell whose files are kept but that
    ``BENCHMARK.json`` does not list, one made from its name
    (``<traffic>.<config>``)."""
    for c in manifest()["workloads"]:
        if c["name"] == name:
            return c
    traffic, config = name.split(".", 1)
    return {"name": name, "config": config, "traffic": traffic, "chips": 1}


def tiny(config: dict, capacity: int) -> dict:
    c = copy.deepcopy(config)
    c["compute_dtype"] = "float32"
    rc = c["run_config"]
    rc["backbone"] = "tiny"
    rc["models"][rc["model_name"]]["feat_size"] = 8
    rc["budget_overrides"] = dict(BUDGETS)
    rc["data"]["voxel_capacity"] = capacity
    rc["data"]["eval_voxel_capacity"] = capacity
    return c


def tiny_train(workload: str):
    w = cell(workload)
    config = tiny(load(HERE, "configs", f"{w['config']}.json"), 4096)
    traffic = load(HERE, "traffic", f"{w['traffic']}.json")
    traffic.update(batch_tiles=2, pool_tiles=6, check_steps=3, warmup_steps=1)
    traffic["tile"].update(n_instances=4, pts_per_instance=120, n_ground=1200, radius=5.0,
                           grid_size=0.2)
    return w, config, traffic


def tiny_serve(workload: str):
    w = cell(workload)
    config = tiny(load(HERE, "configs", f"{w['config']}.json"), 4096)
    config["run_config"]["data"]["radius"] = 5
    traffic = load(HERE, "traffic", f"{w['traffic']}.json")
    traffic.update(forests=2, warm_scenes=1)
    traffic["scene"].update(extent=9.0, n_trees=6, pts_per_tree=300, n_ground=6000)
    return w, config, traffic
