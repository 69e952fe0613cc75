"""The port's dense BA with its edges split over two processes (CPU, gloo).

Two spawned ranks (`tests/_torch_dist.py:run_ranks`) run
`make_sharded_accumulate`, `make_sharded_cost`, `make_sharded_optimizer`
and `optimize_dense_ba_scheduled(group=WORLD)` on `tests/test_ba.py`'s
4-keyframe problem with noisy poses, its 12 edges padded with two (0, 0)
edges (7 a rank), and are held to one process on the same padded problem:
H, b and the cost within 1e-5 of their largest entry (sums in another
order), poses within 1e-4 and log-scales within 1e-5 over 6 LM-guarded
iterations (the JAX package's bars for its mesh, `tests/test_ba.py:
207-214`), both ranks bit-equal. An edge count that does not split over
the ranks raises on every rank.
"""
import numpy as np
import pytest
import torch

import dro_sfm_torch.ba.dense_ba as T
from tests._torch_dist import ba_rank, load, run_ranks
from tests.test_torch_ba import noisy
from tools.torch_bench_ba import pad_edges


@pytest.fixture(scope="module")
def padded():
    _, tp = noisy(seed=6, sigma=0.03)
    problem = pad_edges(tp._replace(edges_i=torch.cat([tp.edges_i, tp.edges_i[:1]]),
                                    edges_j=torch.cat([tp.edges_j, tp.edges_j[:1]])), 2)
    assert problem.edges_i.shape[0] == 14 and problem.edges_i[-1] == 0
    return problem


def test_edge_split_on_two_ranks_matches_one_process(padded, tmp_path):
    run_ranks(ba_rank, 2, tmp_path, [t.numpy() for t in padded], str(tmp_path))
    ranks = load(tmp_path, 2)
    for key in ("H", "b", "cost", "poses", "sigmas"):
        assert torch.equal(ranks[0][key], ranks[1][key]), key
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["sched"], ranks[1]["sched"]))
    got = ranks[0]
    H, b = T._accumulate(padded, 2, 0.25)
    for key, want in (("H", H), ("b", b), ("cost", T._total_cost(padded, 2, 0.25))):
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    poses, sigmas = T.optimize_dense_ba(padded, stride=2, iters=6)
    np.testing.assert_allclose(got["poses"].numpy(), poses.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["sigmas"].numpy(), sigmas.numpy(), rtol=0, atol=1e-5)
    sp, ss = T.optimize_dense_ba_scheduled(padded, stages=((2, 0.5, 2, 0.15),
                                                           (1, 0.25, 3, 0.1)), stride=2)
    np.testing.assert_allclose(got["sched"][0].numpy(), sp.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["sched"][1].numpy(), ss.numpy(), rtol=0, atol=1e-5)
    assert all(r["refused"] and "13 edges do not split over 2" in r["refused"]
               for r in ranks)
