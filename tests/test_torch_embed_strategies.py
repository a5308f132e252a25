"""The embed family's strategy table on the tiny plan against the JAX
package, with per-sample subset counters: strategies 14 (HDBSCAN on the
embedding), 2 (HDBSCAN on nine random subsets of xyz + embedding, then on
the embedding) and 12 (region growing on positions, then mean shift on six
random subsets of the embedding), the eval forward and the first full train
step, through ``test_torch_settings.py``'s ``run_case`` and checks (same
weights, tolerances and exact membership). HDBSCAN runs on embeddings that
are not on a dyadic grid, so its Gram-matrix distances may round
differently in the two frameworks (``test_torch_hdbscan.py``); on these
inputs no tree edge flips, and the membership is compared exactly."""

import pytest
import torch

from test_torch_settings import (
    HEADS,
    arrays,  # noqa: F401 (the module fixture of the inputs)
    check_eval_proposals,
    check_eval_scores,
    check_heads,
    check_membership_blocks,
    check_train_step_losses,
    check_train_step_proposals,
    run_case,
)

torch.set_num_threads(2)

CASES = {
    "embed14": dict(model_family="embed", cluster_type=14, use_score_net=False,
                    hd_min_cluster_size=8),
    "embed2": dict(model_family="embed", cluster_type=2, use_score_net=False),
    "embed12": dict(model_family="embed", cluster_type=12, use_score_net=False),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request, arrays):  # noqa: F811
    return run_case(request.param, CASES[request.param], arrays)


@pytest.mark.parametrize("name", HEADS)
def test_heads(case, name):
    check_heads(case, name)


def test_eval_proposals(case):
    check_eval_proposals(case)


def test_eval_scores(case):
    check_eval_scores(case)


def test_train_step_losses(case):
    check_train_step_losses(case)


def test_train_step_proposals(case):
    check_train_step_proposals(case)


def test_membership_blocks(case):
    check_membership_blocks(case)


def test_subset_runs_differ(case):
    """The random-subset runs cluster different subspaces: their blocks'
    memberships are not all the same."""
    cfg, tp = case["cfg"], case["tout"].proposals
    if all(op[2] == 0 for op in cfg.embed_ops):
        return
    blocks = tp.prop_id.reshape(-1, case["tout"].semantic_logits.shape[0]) >= 0
    assert len({tuple(b.tolist()) for b in blocks}) > 1
