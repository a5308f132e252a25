"""Voting runs 2 and 3 of the whole scene (re-tilings with shifted grid
origins): the port's ``FullSceneEvaluator`` at 1 and 2 tiles per dispatch
against the JAX evaluator's voting runs, on the forest, weights and
settings of ``test_torch_evaluator.py`` (at 1 tile per dispatch on the JAX
side: on this scene the budgets do not bind, so grouping changes no label,
as that file's grouped-dispatch test shows). Tolerances: per-point
semantic and instance labels identical; report floats within 1e-6."""

import concurrent.futures

import numpy as np
import pytest

from test_torch_evaluator import (  # noqa: F401 (the module fixture of the inputs)
    _labels,
    jax_scenes,
    port_scene,
    reference,
)
from torch_jax_cache import jax_compilation_cache  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def votes(reference):  # noqa: F811
    """Labels and reports of voting runs 2 and 3: the JAX evaluator's (its
    compiled forward reused) and the port's at g = 1 and 2, and the port's
    single run at g = 1. The port's scenes run in a second thread while
    this one runs the JAX evaluator."""
    tmp = reference["tmp"]

    def port_votes():
        out = {("port", 1, 1): (port_scene(reference, 1, tmp / "port_g1"), tmp / "port_g1")}
        for g in (1, 2):
            for runs in (2, 3):
                d = tmp / f"port_v{runs}_g{g}"
                out["port", g, runs] = (port_scene(reference, g, d, runs), d)
        return out

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(port_votes)
        jax_side = jax_scenes(reference, (2, 3))
        out = port.result()
    out.update({("jax", runs): v for runs, v in jax_side.items()})
    return out


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("runs", [2, 3])
def test_voting_runs_match_jax(votes, g, runs):
    (jrep, jdir), (prep, pdir) = votes["jax", runs], votes["port", g, runs]
    for kind in ("semantic", "instance"):
        np.testing.assert_array_equal(_labels(pdir, kind), _labels(jdir, kind), err_msg=kind)
    assert len(prep) == len(jrep) == 1 and set(prep[0]) == set(jrep[0])
    for k, v in jrep[0].items():
        assert prep[0][k] == pytest.approx(v, abs=1e-6), k


def test_voting_runs_change_the_labels(votes):
    """The re-tilings vote: three runs do not label every point as one run."""
    one, three = votes["port", 1, 1][1], votes["port", 1, 3][1]
    assert any(not np.array_equal(_labels(three, kind), _labels(one, kind))
               for kind in ("semantic", "instance"))
