"""Parallel tree learners and boosting without a GP model: the PyTorch port
against the JAX package.

`spawn_train` runs the port's data-, feature- and voting-parallel learners
in 2 and 4 local gloo ranks on the CPU (all four models of one world size in
one spawned group), against the JAX package's `train(...,
num_parallel_devices=k, tree_learner=...)` on conftest's virtual CPU
devices, on tests/test_parallel.py's data. Split features and bins are
equal; predictions agree to rtol 1e-5 (the JAX suite's own 1-vs-8-device
tolerance: float32 histogram sums in another order). `spawn_train` itself
raises when the ranks grew different trees.
"""

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting.tree_learner import (
    grow_tree, grow_tree_partitioned, grow_tree_voting)
from gpboost_tpu_torch.convert import booster_from_jax_dict
from gpboost_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

BASE = {"objective": "regression", "num_leaves": 15, "verbose": 0}
ROUNDS = 5


def _xy(seed, n, p, coef):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, p)
    y = X[:, 0] - 2.0 * X[:, 1] + 0.3 * rng.randn(n)
    for j, c in coef:
        y = y + c * X[:, j]
    return X, y


# tests/test_parallel.py's problems: name -> (data, learner parameters)
JOBS = {
    "data": (_xy(5, 1000, 6, []), {"tree_learner": "data"}),
    "feature": (_xy(6, 800, 40, [(20, 0.5)]), {"tree_learner": "feature"}),
    "voting_top_k_p": (_xy(7, 960, 6, [(3, 0.5)]),
                       {"tree_learner": "voting", "top_k": 6}),
    "voting_top_k_3": (_xy(7, 960, 6, [(3, 0.5)]),
                       {"tree_learner": "voting", "top_k": 3}),
}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda k: f"{k}ranks")
def port_boosters(request):
    names = list(JOBS)
    boosters = gpt.spawn_train(
        [{**BASE, **JOBS[k][1]} for k in names],
        [JOBS[k][0][0] for k in names], [JOBS[k][0][1] for k in names],
        num_boost_round=ROUNDS, world_size=request.param, backend="gloo",
        device="cpu")
    return request.param, dict(zip(names, boosters))


def _splits(tree):
    internal = np.flatnonzero(~tree.is_leaf[:tree.num_nodes])
    return [(int(i), int(tree.split_feature[i]), int(tree.threshold_bin[i]))
            for i in internal]


def _assert_same_model(bj, bp, X):
    assert len(bp.trees) == len(bj.trees) == ROUNDS
    for tj, tp in zip(bj.trees, bp.trees):
        assert _splits(tp) == _splits(tj)
    np.testing.assert_allclose(bp.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("job", list(JOBS))
def test_parallel_learner_matches_jax_mesh(port_boosters, job):
    k, boosters = port_boosters
    (X, y), learner = JOBS[job]
    bj = gpb.train({**BASE, **learner, "num_parallel_devices": k},
                   gpb.Dataset(X, label=y), num_boost_round=ROUNDS)
    assert bj.learner.mesh is not None
    _assert_same_model(bj, boosters[job], X)


def test_serial_boosting_without_gp_matches_jax():
    (X, y), _ = JOBS["data"]
    params = {**BASE, "min_data_in_leaf": 10, "lambda_l2": 1.0}
    bj = gpb.train(params, gpb.Dataset(X, label=y), num_boost_round=ROUNDS)
    bp = gpt.train(params, gpt.Dataset(X, label=y), num_boost_round=ROUNDS,
                   device="cpu")
    assert bp.gp_model is None and bp.learner.group is None
    _assert_same_model(bj, bp, X)
    # the model dict moves both ways
    bl, gl = booster_from_jax_dict(bj.model_to_dict(), device="cpu")
    assert gl is None
    np.testing.assert_allclose(bl.predict(X), bj.predict(X), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(
        gpb.Booster(model_dict=bp.model_to_dict()).predict(X), bp.predict(X),
        rtol=0, atol=1e-12)


def test_masked_modes_agree_in_one_process():
    """Without a group the collectives are the identity: the data, feature
    and voting learners (2 * top_k >= p) grow the same tree as each other,
    and as the positional learner up to float32 sums in another order."""
    (X, y), _ = JOBS["feature"]
    ds = gpt.Dataset(X, label=y)
    ds.construct()
    B = int(ds.num_bins)
    bins_T = torch.as_tensor(np.ascontiguousarray(ds.bins.T, dtype=np.uint8))
    stats_T = torch.ones((3, len(y)), dtype=torch.float32)
    stats_T[0] = torch.as_tensor(-y, dtype=torch.float32)
    args = (bins_T, stats_T, B, 15, 10 ** 6, 0.0, 20.0, 1e-3, 0.0)
    data = grow_tree(*args)
    for other in (grow_tree(*args, mode="feature", feat_range=(0, 40)),
                  grow_tree_voting(*args, top_k=20)):
        np.testing.assert_array_equal(other[0], data[0])
        np.testing.assert_array_equal(other[1], data[1])
    pos = grow_tree_partitioned(bins_T.T.contiguous(),
                                stats_T.T.contiguous(), *args[2:])
    np.testing.assert_array_equal(pos[0], data[0])
    np.testing.assert_allclose(pos[1], data[1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        np.bincount(pos[2].numpy(), minlength=15), data[4])


def test_parallel_booster_needs_a_group_and_no_gp_model():
    (X, y), _ = JOBS["data"]
    with pytest.raises(ValueError, match="process group"):
        gpt.Booster({**BASE, "num_parallel_devices": 2},
                    gpt.Dataset(X, label=y), device="cpu")
    coords = np.random.RandomState(0).rand(len(y), 2)
    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=5, device="cpu")
    with pytest.raises(NotImplementedError):
        gpt.Booster({**BASE, "num_parallel_devices": 2,
                     "tree_learner": "data"}, gpt.Dataset(X, label=y),
                    gp_model=gp)
    with pytest.raises(ValueError, match="tree_learner"):
        gpt.Booster({**BASE, "tree_learner": "diagonal"},
                    gpt.Dataset(X, label=y), device="cpu")


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt.Booster(BASE, gpt.Dataset(*JOBS["data"][0][:1],
                                      label=JOBS["data"][0][1]))
    assert resolve_device("cpu") == torch.device("cpu")
