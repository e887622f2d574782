"""Tree learner of the PyTorch port against the JAX package.

The same features, gradients and hessians (numpy, seeded) go through
gpboost_tpu's SerialTreeLearner (positional path, one-hot einsum histograms
on the CPU) and the port's learner (plain histogram version on the CPU).
Split records and the row -> leaf assignment are equal; leaf values agree to
1e-6 (float32 histogram sums in another order). n >= 256 keeps the JAX
learner free of padding rows, as the port is.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpboost_tpu.boosting.dataset import Dataset as JaxDataset
from gpboost_tpu.boosting.tree_learner import (
    SerialTreeLearner as JaxLearner, _best_split_of_hist as jax_best_split)
from gpboost_tpu_torch.boosting.dataset import Dataset
from gpboost_tpu_torch.boosting.tree_learner import (
    SerialTreeLearner, _best_split_of_hist)

torch.set_num_threads(1)


def _problem(n, p, seed):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, p)
    grad = (np.sin(4 * X[:, 0]) + X[:, 1] * X[:, 2]
            + 0.3 * rng.randn(n))
    hess = 0.5 + rng.rand(n)
    return X, grad, hess


def _assert_same_tree(tj, tp):
    nn = tj.num_nodes
    assert tp.num_nodes == nn
    for attr in ("split_feature", "threshold_bin", "left", "right",
                 "is_leaf"):
        np.testing.assert_array_equal(getattr(tp, attr)[:nn],
                                      getattr(tj, attr)[:nn], err_msg=attr)
    np.testing.assert_array_equal(tp.threshold_real[:nn],
                                  tj.threshold_real[:nn])
    np.testing.assert_array_equal(tp.cover[:nn], tj.cover[:nn])
    np.testing.assert_allclose(tp.leaf_value[:nn], tj.leaf_value[:nn],
                               rtol=0, atol=1e-6)
    # a gain is a float32 difference of G^2/H terms as large as the root's
    # gain: it carries a few ulps of that scale
    scale = max(1.0, float(np.max(tj.split_gain[:nn])))
    np.testing.assert_allclose(tp.split_gain[:nn], tj.split_gain[:nn],
                               rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("n,max_bin,kw", [
    (500, 255, dict(num_leaves=7)),
    (500, 255, dict(num_leaves=31, min_data_in_leaf=5, lambda_l2=1.0)),
    (500, 63, dict(num_leaves=15, max_depth=3, lambda_l1=0.1,
                   min_gain_to_split=0.01)),
    (1200, 400, dict(num_leaves=15, min_data_in_leaf=10)),   # int32 bins
])
def test_tree_matches_jax_learner(n, max_bin, kw):
    X, grad, hess = _problem(n, 5, seed=n + max_bin)
    jl = JaxLearner(JaxDataset(X, label=grad, max_bin=max_bin), **kw)
    tl = SerialTreeLearner(Dataset(X, label=grad, max_bin=max_bin),
                           device="cpu", **kw)
    assert tl.bins_pos.dtype == (torch.uint8 if tl.num_bins <= 256
                                 else torch.int32)
    tj, slot_j, lv_j = jl.train(grad, hess)
    tp, slot_p, lv_p = tl.train(grad, hess)
    _assert_same_tree(tj, tp)
    np.testing.assert_array_equal(slot_p.numpy(), slot_j)
    np.testing.assert_allclose(lv_p, lv_j, rtol=0, atol=1e-6)


def test_best_split_first_maximum_rule():
    """Duplicated features tie exactly: both learners take the first
    maximum of the flattened (direction, feature, bin) gains."""
    rng = np.random.RandomState(7)
    h = np.abs(rng.randn(2, 3, 16)).astype(np.float32)
    h[:, 0] = rng.randn(2, 16).astype(np.float32)
    h[:, 2] = np.round(h[:, 2] * 10)
    hist = np.concatenate([h, h[::-1], h]).astype(np.float32)   # (6, 3, 16)
    args = (0.5, 1.0, 1e-3, 0.0)
    gj, fj, bj = jax_best_split(jnp.asarray(hist), *(jnp.float32(a)
                                                     for a in args))
    gp, fp, bp = _best_split_of_hist(torch.as_tensor(hist), *args)
    assert (int(fp), int(bp)) == (int(fj), int(bj))
    assert int(fp) in (0, 1)
    np.testing.assert_allclose(float(gp), float(gj), rtol=1e-6)


@pytest.mark.parametrize("case", ["categorical", "missing"])
def test_unported_features_raise(case):
    X, grad, _ = _problem(300, 3, seed=1)
    if case == "categorical":
        X[:, 0] = np.floor(X[:, 0] * 5)
        ds = Dataset(X, label=grad, categorical_feature=[0])
    else:
        X[::7, 1] = np.nan
        ds = Dataset(X, label=grad)
    # the single-device learner takes both (tests/test_torch_tree_breadth.py);
    # the masked learners over a process group refuse them (ROADMAP A15)
    # before they touch the group
    SerialTreeLearner(ds, device="cpu")
    with pytest.raises(NotImplementedError, match="A15"):
        SerialTreeLearner(ds, device="cpu", group=object())
