"""Plain boosting's objectives, bagging and feature_fraction in the PyTorch
port against the JAX package.

One data shape for the file: n = 400, p = 5, 7-leaf trees, float64 scores.
The JAX side runs its host loop (a callback turns the fused scan off, as
tests/test_torch_gpboost_slice.py does). Tolerances: tree splits equal;
init scores and renewed leaf values (l1, quantile, mape) exact; training
scores and predictions after the output transform within 1e-6 (the float32
histogram tier of tests/test_torch_gpboost_slice.py: leaf values are
float32 histogram sums in another order); the likelihood objectives' d1 and
d2 are the port's torch.func derivatives, which
tests/test_torch_likelihoods.py holds to the JAX package's at 1e-10.

Unweighted quantile gradients take two values, 1 - alpha and -alpha, so
candidate splits tie exactly from the second tree on, and the packages'
float32 histogram sums (in different orders) break those ties differently:
that case runs one round, and its renewal is held exact by
test_segment_percentiles_equal_weighted_percentile on random segments.
"""

import numpy as np
import pytest
import torch

import gpboost_tpu as gpb
import gpboost_tpu_torch as gpt
from gpboost_tpu_torch.boosting.gbdt import (_segment_percentiles,
                                             _weighted_percentile)

torch.set_num_threads(1)

N, P, ROUNDS = 400, 5, 3
BASE = {"num_leaves": 7, "learning_rate": 0.3, "verbose": 0}
SAMPLING = {"bagging_fraction": 0.8, "bagging_freq": 1,
            "feature_fraction": 0.8}


def _data():
    rng = np.random.RandomState(1)
    X = rng.rand(N, P)
    y = 2 * X[:, 0] + np.sin(5 * X[:, 1]) + 0.5 * rng.randn(N)
    w = 0.2 + rng.rand(N)
    mu = np.exp(0.5 * (y - y.mean()))
    labels = {
        "binary": (y > np.median(y)).astype(float),
        "poisson": rng.poisson(mu).astype(float),
        "gamma": np.exp(0.3 * y) + 0.1,
        "tweedie": rng.poisson(mu).astype(float),
        "cross_entropy": 1.0 / (1.0 + np.exp(-(y - y.mean()))),
        "cross_entropy_lambda": 1.0 / (1.0 + np.exp(-(y - y.mean()))),
        "l1": y, "quantile": y, "huber": y, "fair": y, "mape": y,
    }
    return X, w, labels


X, W, LABELS = _data()


def _train_both(params, label, weight=None, rounds=ROUNDS):
    bj = gpb.train(params, gpb.Dataset(X, label=label, weight=weight),
                   num_boost_round=rounds, callbacks=[lambda env: None])
    bp = gpt.train(params, gpt.Dataset(X, label=label, weight=weight),
                   num_boost_round=rounds, device="cpu")
    return bj, bp


def _assert_same_splits(bj, bp):
    assert len(bp.trees) == len(bj.trees)
    for k, (tj, tp) in enumerate(zip(bj.trees, bp.trees)):
        nn = tj.num_nodes
        assert tp.num_nodes == nn, f"tree {k}"
        internal = ~tj.is_leaf[:nn]
        np.testing.assert_array_equal(tp.is_leaf[:nn], tj.is_leaf[:nn])
        np.testing.assert_array_equal(tp.split_feature[:nn][internal],
                                      tj.split_feature[:nn][internal],
                                      err_msg=f"tree {k}")
        np.testing.assert_array_equal(tp.threshold_bin[:nn][internal],
                                      tj.threshold_bin[:nn][internal],
                                      err_msg=f"tree {k}")


def _leaf_values(b):
    return np.concatenate([t.leaf_value[:t.num_nodes][t.is_leaf[:t.num_nodes]]
                           for t in b.trees])


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted",
                                                         "weighted"])
@pytest.mark.parametrize("objective", sorted(LABELS))
def test_objective_matches_jax(objective, weighted):
    label = LABELS[objective]
    rounds = 1 if objective == "quantile" and not weighted else ROUNDS
    params = {**BASE, "objective": objective}
    bj, bp = _train_both(params, label, W if weighted else None, rounds)
    assert bp.objective_name == bj.objective_name
    assert bp.init_score == bj.init_score
    _assert_same_splits(bj, bp)
    np.testing.assert_allclose(bp.F.numpy(), bj.F, rtol=0, atol=1e-6)
    if objective in ("l1", "quantile", "mape"):
        np.testing.assert_array_equal(_leaf_values(bp), _leaf_values(bj))
    for raw in (False, True):
        np.testing.assert_allclose(bp.predict(X, raw_score=raw),
                                   np.asarray(bj.predict(X, raw_score=raw)),
                                   rtol=0, atol=1e-6, err_msg=f"raw {raw}")


@pytest.mark.parametrize("objective", ["binary", "l1", "mape", "regression"])
def test_bagging_and_feature_fraction_match_jax(objective):
    label = LABELS.get(objective, LABELS["l1"])
    params = {**BASE, "objective": objective, **SAMPLING,
              "bagging_seed": 11, "feature_fraction_seed": 5}
    bj, bp = _train_both(params, label, W if objective == "mape" else None,
                         rounds=4)
    _assert_same_splits(bj, bp)
    if objective in ("l1", "mape"):
        np.testing.assert_array_equal(_leaf_values(bp), _leaf_values(bj))
    np.testing.assert_allclose(bp.predict(X), np.asarray(bj.predict(X)),
                               rtol=0, atol=1e-6)
    # each tree used at most 4 of the 5 features
    for t in bp.trees:
        used = set(t.split_feature[:t.num_nodes][~t.is_leaf[:t.num_nodes]])
        assert len(used) <= 4


def test_bagging_with_a_grouped_gp_model_matches_jax():
    rng = np.random.RandomState(3)
    group = rng.randint(0, 20, N)
    y = LABELS["l1"] + 0.8 * rng.randn(20)[group]
    params = {**BASE, "objective": "regression", **SAMPLING}
    gj = gpb.GPModel(group_data=group)
    bj = gpb.train(params, gpb.Dataset(X, label=y), num_boost_round=3,
                   gp_model=gj, callbacks=[lambda env: None])
    gp = gpt.GPModel(group_data=group, device="cpu")
    bp = gpt.train(params, gpt.Dataset(X, label=y), num_boost_round=3,
                   gp_model=gp)
    _assert_same_splits(bj, bp)
    np.testing.assert_allclose(gp.get_cov_pars(), gj.get_cov_pars(),
                               rtol=1e-5)
    g_new = np.arange(10)
    pj = bj.predict(X[:10], group_data_pred=g_new)
    pp = bp.predict(X[:10], group_data_pred=g_new)
    np.testing.assert_allclose(pp["response_mean"], pj["response_mean"],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("options", [
    {"objective": "binary", "is_unbalance": True},
    {"objective": "binary", "scale_pos_weight": 2.5, "sigmoid": 0.7},
    {"objective": "huber", "alpha": 0.4},
    {"objective": "quantile", "alpha": 0.3},
    {"objective": "fair", "fair_c": 0.5},
    {"objective": "tweedie", "tweedie_variance_power": 1.2},
], ids=["is_unbalance", "scale_pos_weight_sigmoid", "huber_alpha",
        "quantile_alpha", "fair_c", "tweedie_power"])
def test_objective_settings_match_jax(options):
    obj = options["objective"]
    label = LABELS[obj]
    weighted = obj == "quantile"
    bj, bp = _train_both({**BASE, **options}, label,
                         W if weighted else None)
    assert bp.objective_name == bj.objective_name
    assert bp.init_score == bj.init_score
    _assert_same_splits(bj, bp)
    np.testing.assert_allclose(bp.predict(X), np.asarray(bj.predict(X)),
                               rtol=0, atol=1e-6)
    if obj == "binary":
        assert bp._binary_lw == bj._binary_lw
        assert bp.objective_name == "binary_lgb"


def test_segment_percentiles_equal_weighted_percentile():
    """The device leaf renewal equals the reference's per-leaf
    _weighted_percentile bit for bit: np.percentile's interpolation
    unweighted, the cumulative-weight cut weighted."""
    rng = np.random.RandomState(0)
    for trial in range(120):
        n, L = rng.randint(1, 60), rng.randint(1, 6)
        v = rng.randn(n)
        key = rng.randint(0, L, n)
        w = rng.rand(n) if trial % 2 else None
        alpha = (0.5, 0.9, 0.1, 0.25, 0.73)[trial % 5]
        counts = np.bincount(key, minlength=L + 1)
        got = _segment_percentiles(
            torch.as_tensor(v), torch.as_tensor(key), counts,
            None if w is None else torch.as_tensor(w), alpha).numpy()
        want = [_weighted_percentile(v[key == k],
                                     None if w is None else w[key == k],
                                     alpha)
                for k in np.flatnonzero(counts > 0)]
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_predict_slices_and_early_stop_match_jax():
    params = {**BASE, "objective": "binary"}
    bj, bp = _train_both(params, LABELS["binary"], rounds=6)
    for kw in ({"num_iteration": 2}, {"start_iteration": 2},
               {"start_iteration": 1, "num_iteration": 3},
               {"pred_early_stop": True, "pred_early_stop_freq": 2,
                "pred_early_stop_margin": 1.0}):
        for raw in (False, True):
            np.testing.assert_allclose(
                bp.predict(X, raw_score=raw, **kw),
                np.asarray(bj.predict(X, raw_score=raw, **kw)), rtol=0,
                atol=1e-6, err_msg=str(kw))
    # raw slices over start_iteration sum to the full raw score
    full = bp.predict(X, raw_score=True)
    parts = bp.predict(X, raw_score=True, num_iteration=2) \
        + bp.predict(X, raw_score=True, start_iteration=2)
    np.testing.assert_allclose(parts, full, rtol=0, atol=1e-12)
    assert bp.num_trees() == 6 and bp.current_iteration() == 6


def test_nesterov_predict_slices_match_jax():
    params = {**BASE, "objective": "regression", "use_nesterov_acc": True}
    bj, bp = _train_both(params, LABELS["l1"], rounds=4)
    for kw in ({}, {"num_iteration": 2}, {"num_iteration": 3}):
        np.testing.assert_allclose(bp.predict(X, **kw),
                                   np.asarray(bj.predict(X, **kw)),
                                   rtol=0, atol=1e-6, err_msg=str(kw))
    with pytest.raises(ValueError, match="start_iteration"):
        bp.predict(X, start_iteration=2)


@pytest.mark.parametrize("objective", ["binary_lgb", "poisson", "tweedie"])
def test_model_dicts_load_both_ways(objective):
    params = {**BASE, "objective": objective}
    label = LABELS["poisson" if objective != "binary_lgb" else "binary"]
    if objective == "binary_lgb":
        params.update(objective="binary", is_unbalance=True)
    bj, bp = _train_both(params, label)
    from gpboost_tpu_torch.convert import booster_from_jax_dict
    bc, gc = booster_from_jax_dict(bj.model_to_dict(), device="cpu")
    assert gc is None
    np.testing.assert_allclose(bc.predict(X), np.asarray(bj.predict(X)),
                               rtol=0, atol=1e-12)
    bl = gpb.Booster(model_dict=bp.model_to_dict())
    np.testing.assert_allclose(np.asarray(bl.predict(X)), bp.predict(X),
                               rtol=0, atol=1e-12)
    bs = gpt.Booster(model_dict=bp.model_to_dict(), device="cpu")
    np.testing.assert_array_equal(bs.predict(X), bp.predict(X))


def test_eval_train_and_reset_parameter():
    bj, bp = _train_both({**BASE, "objective": "regression"}, LABELS["l1"])
    (nj, mj, vj, hj), = bj.eval_train()
    (np_, mp, vp, hp), = bp.eval_train()
    assert (nj, mj, hj) == (np_, mp, hp)
    np.testing.assert_allclose(vp, vj, rtol=1e-6)
    bp.reset_parameter({"eta": 0.05, "sub_row": 0.5})
    assert bp.params["learning_rate"] == 0.05
    assert bp.params["bagging_fraction"] == 0.5
    assert gpt.train({**BASE, "objective": "binary"},
                     gpt.Dataset(X, label=LABELS["binary"]),
                     num_boost_round=1, device="cpu").eval_train() == []


# the booster's modes and objectives are ported
# (tests/test_torch_booster_modes.py): what the reference refuses raises,
# the ranking objectives without query information and a random forest
# without bagging; the others train
@pytest.mark.parametrize("params,item", [
    ({"objective": "multiclass", "num_class": 3}, None),
    ({"objective": "lambdarank"}, "query information"),
    ({"objective": "rank_xendcg"}, "query information"),
    ({"objective": "tobit"}, None),
    ({"objective": "mean_scale_regression"}, None),
    ({"boosting": "dart"}, None),
    ({"boosting": "goss"}, None),
    ({"boosting": "rf"}, "bagging"),
])
def test_out_of_slice_options_raise(params, item):
    label = np.floor(3 * X[:, 0])
    if item is not None:
        with pytest.raises(ValueError, match=item):
            gpt.train({**BASE, **params}, gpt.Dataset(X, label=label),
                      num_boost_round=1, device="cpu")
        return
    bst = gpt.train({**BASE, **params}, gpt.Dataset(X, label=label),
                    num_boost_round=1, device="cpu")
    assert bst.num_trees() == bst._nsets


def test_out_of_slice_train_and_predict_options_raise():
    ds = gpt.Dataset(X, label=LABELS["l1"])
    bp = gpt.train(BASE, ds, num_boost_round=1, device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        gpt.train(BASE, ds, num_boost_round=1, init_model=bp, device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        gpt.train(BASE, ds, num_boost_round=1, keep_training_booster=True,
                  device="cpu")
    # pred_contrib and pred_leaf are ported (tests/test_torch_tree_breadth.py)
    np.testing.assert_allclose(bp.predict(X, pred_contrib=True).sum(1),
                               bp.predict(X, raw_score=True), rtol=0,
                               atol=1e-12)
    assert bp.predict(X, pred_leaf=True).shape == (len(X), 1)
    # ndcg is ported (tests/test_torch_booster_modes.py); it needs query
    # information on the validation set, as in the reference
    with pytest.raises(ValueError, match="query information"):
        gpt.train({**BASE, "metric": "ndcg"}, ds, num_boost_round=1,
                  valid_sets=[gpt.Dataset(X, label=LABELS["l1"])],
                  device="cpu")
